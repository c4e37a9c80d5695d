"""GNN backbone sub-layers (single client, plain PyTorch)."""
