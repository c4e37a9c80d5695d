# glint: disable-file=GL010 loaded dynamically via importlib in configs.base (GNN_ARCH_IDS registry)
"""GLASU split-GAT [paper §5.3 backbone study] — 2-head attention layers.

Attention coefficients are client-local (each client attends over its own
sampled bipartite graph); aggregation across clients stays parameter-free.
"""
from ..api.config import ExperimentConfig

CONFIG = ExperimentConfig(
    name="glasu_gat", dataset="cora", method="glasu", backbone="gat",
    n_clients=3, n_layers=4, hidden=64, gat_heads=2, k=2, n_local_steps=4,
    rounds=200, lr=0.01, optimizer="adam",
)


def reduced() -> ExperimentConfig:
    return CONFIG.with_(name="glasu_gat-reduced", dataset="tiny", hidden=16,
                        batch_size=8, size_cap=96, rounds=8, eval_every=4)
