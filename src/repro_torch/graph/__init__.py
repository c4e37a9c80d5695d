"""Host-side graph data: CSR graphs, synthetic datasets, batches."""
