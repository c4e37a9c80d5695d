# glint: disable-file=GL010 loaded dynamically via importlib in configs.base (GNN_ARCH_IDS registry)
"""GLASU split-GCNII [paper §5.1] — the headline backbone (Tables 2-4).

L=4, hidden=64, M=3 clients, K=2 uniform aggregation (layers 1,3), Q=4 stale
updates, Adam lr=0.01 on the Cora proxy.
"""
from ..api.config import ExperimentConfig

CONFIG = ExperimentConfig(
    name="glasu_gcnii", dataset="cora", method="glasu", backbone="gcnii",
    n_clients=3, n_layers=4, hidden=64, k=2, n_local_steps=4,
    rounds=200, lr=0.01, optimizer="adam",
)


def reduced() -> ExperimentConfig:
    return CONFIG.with_(name="glasu_gcnii-reduced", dataset="tiny", hidden=16,
                        batch_size=8, size_cap=96, rounds=8, eval_every=4)
