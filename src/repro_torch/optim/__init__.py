"""Functional optimizers over the client-stacked parameter tree."""
