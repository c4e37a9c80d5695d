"""GNN backbone sub-layers (single client) and the transformer stack's
layers, GQA attention and decoder assembly (plain PyTorch)."""
