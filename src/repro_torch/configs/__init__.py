"""Architecture configs: the transformer zoo's schema and the paper's GNN
scenarios (counterpart of ``repro.configs``)."""
