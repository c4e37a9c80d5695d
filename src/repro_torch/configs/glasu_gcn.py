# glint: disable-file=GL010 loaded dynamically via importlib in configs.base (GNN_ARCH_IDS registry)
"""GLASU split-GCN [paper §5.3 backbone study] — plain GCN client layers.

Same split/aggregation schedule as the GCNII config; GCN is also the only
backbone supporting concat aggregation (kept on mean here, matching §5.2).
"""
from ..api.config import ExperimentConfig

CONFIG = ExperimentConfig(
    name="glasu_gcn", dataset="cora", method="glasu", backbone="gcn",
    n_clients=3, n_layers=4, hidden=64, k=2, n_local_steps=4,
    rounds=200, lr=0.01, optimizer="adam",
)


def reduced() -> ExperimentConfig:
    return CONFIG.with_(name="glasu_gcn-reduced", dataset="tiny", hidden=16,
                        batch_size=8, size_cap=96, rounds=8, eval_every=4)
