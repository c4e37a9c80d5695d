"""End-to-end driver (the paper's task): GLASU against the paper's
baselines on one dataset, with the privacy hooks and the compressed
exchange.

    PYTHONPATH=src python -m repro_torch.examples.vfl_graph_training \\
        [--dataset suzhou] [--rounds 150] [--backend vmapped] [--device cpu]

The port's counterpart of ``examples/vfl_graph_training.py``. Every row is
one ``ExperimentConfig``: the method (centralized / standalone /
simulated-centralized / glasu) picks the aggregation schedule, the client
count and the eval mode; the compressed rows show the bytes a round
dropping with the accuracy held.
"""
from __future__ import annotations

import argparse

from ..api import ExperimentConfig, Trainer
from ..core.train import make_centralized_dataset
from ..device import resolve_device
from ..graph.synth import make_vfl_dataset


def base_config(dataset: str = "suzhou", rounds: int = 150,
                backend: str = "vmapped") -> ExperimentConfig:
    """The GLASU K=2 Q=1 row; every other row overrides it."""
    return ExperimentConfig(
        name=f"{dataset}-comparison", dataset=dataset,
        n_clients=3, n_layers=4, hidden=64, backbone="gcnii",
        backend=backend, rounds=rounds, rounds_per_step=5,
        lr=0.01, eval_every=30)


def rows(base: ExperimentConfig) -> list:
    """``(label, config)`` of each row in the script's order; the
    secure-agg + DP row only on the vmapped backend (the simulation backend
    has no privacy hooks, and the script runs it on vmapped alone)."""
    out = [
        ("centralized (M=1)", base.with_(method="centralized")),
        ("standalone (no comm)", base.with_(method="standalone")),
        ("simulated-centralized K=4",
         base.with_(method="simulated-centralized")),
        ("GLASU K=2 Q=1", base),
        ("GLASU K=2 Q=4", base.with_(n_local_steps=4)),
        # compressed embedding exchange (wire codecs at the Agg boundary)
        ("GLASU + int8 exchange", base.with_(
            n_local_steps=4, compression={"method": "int8"})),
        ("GLASU + topk_ef k=8", base.with_(
            n_local_steps=4, compression={"method": "topk_ef", "k": 8})),
    ]
    if base.backend == "vmapped":
        # §3.6 privacy hooks; secure-agg masks need the exact dense
        # exchange, so this row stays uncompressed
        out.append(("GLASU + secure-agg + DP", base.with_(
            n_local_steps=4, secure_agg=True, dp_sigma=0.05)))
    return out


def run_row(label: str, cfg: ExperimentConfig, device=None,
            data=None) -> dict:
    """Train one row on ``device`` (default CUDA) and print its line;
    ``data``: the row's dataset (None builds it from ``cfg``)."""
    trainer = Trainer(cfg, data=data, device=device)
    try:
        res = trainer.run()
    finally:
        trainer.close()
    per_round = res.comm_bytes / max(res.rounds_run, 1)
    print(f"{label:30s} acc={res.test_acc * 100:5.1f}%  "
          f"comm={res.comm_bytes / 1e6:8.1f}MB ({per_round / 1e3:6.1f}kB/rd)"
          f"  t={res.wall_seconds:5.1f}s")
    return dict(test_acc=res.test_acc, comm_bytes=res.comm_bytes,
                rounds_run=res.rounds_run, bytes_per_round=per_round,
                wall_seconds=res.wall_seconds)


def _row_data(cfg: ExperimentConfig, data):
    """The row's view of the M-client ``data``: the union graph with the
    full features (M = 1) for centralized, ``data`` itself otherwise."""
    return make_centralized_dataset(data) if cfg.method == "centralized" \
        else data


def run(base: ExperimentConfig, device=None) -> dict:
    """Every row of ``rows(base)`` in order, on one build of the dataset:
    ``{label: run_row(...)}``."""
    device = resolve_device(device)
    print(f"== {base.dataset} ({base.n_clients} clients, vertically "
          f"partitioned, {base.backend} backend) ==")
    data = make_vfl_dataset(base.dataset, n_clients=base.n_clients,
                            seed=base.seed)
    return {label: run_row(label, cfg, device, _row_data(cfg, data))
            for label, cfg in rows(base)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="suzhou")
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--backend", default="vmapped",
                    choices=("vmapped", "simulation", "sharded"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    return run(base_config(args.dataset, args.rounds, args.backend),
               args.device)


if __name__ == "__main__":
    main()
