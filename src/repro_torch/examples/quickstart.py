"""Quickstart: train a GLASU split-GCNII on the Cora proxy.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port's counterpart of ``examples/quickstart.py``: one preset of the
experiment API, 4 rounds a step, the int8 embedding exchange.

    from repro_torch.api import Trainer, get_preset

    cfg = get_preset("cora-gcnii-glasu").with_(rounds=60, eval_every=20)
    result = Trainer(cfg).run()
    print(result.test_acc, result.comm_bytes)
"""
from __future__ import annotations

import argparse

from ..api import ExperimentConfig, Trainer, get_preset


def config() -> ExperimentConfig:
    """The script's experiment: ``cora-gcnii-glasu`` for 60 rounds, an
    exact eval every 20, 4 rounds a step, int8 uploads."""
    return get_preset("cora-gcnii-glasu").with_(
        rounds=60, eval_every=20, rounds_per_step=4,
        compression={"method": "int8"})


def run(cfg: ExperimentConfig, device=None) -> dict:
    """Train ``cfg`` on ``device`` (default CUDA) and print the script's
    summary; returns its numbers."""
    trainer = Trainer(cfg, device=device)
    try:
        res = trainer.run()
    finally:
        trainer.close()
    method = cfg.compression.method if cfg.compression else "none"
    history = [(h["round"], h["test_acc"]) for h in res.history]
    print(f"\nGLASU (K={len(cfg.agg_layers)}, Q={cfg.n_local_steps}, "
          f"{method} exchange) on {cfg.dataset}-proxy:")
    print(f"  test accuracy   : {res.test_acc * 100:.1f}%")
    print(f"  communication   : {res.comm_bytes / 1e6:.1f} MB "
          f"({res.rounds_run} rounds)")
    print(f"  wall time       : {res.wall_seconds:.1f}s")
    print("  history         :",
          [f"r{r}:{acc:.2f}" for r, acc in history])
    return dict(test_acc=res.test_acc, comm_bytes=res.comm_bytes,
                rounds_run=res.rounds_run, wall_seconds=res.wall_seconds,
                history=history)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    return run(config(), args.device)


if __name__ == "__main__":
    main()
