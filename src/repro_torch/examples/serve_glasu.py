"""Serve a trained GLASU model: checkpoint -> session -> queries.

    PYTHONPATH=src python -m repro_torch.examples.serve_glasu [--device cpu]

The port's counterpart of ``examples/serve_glasu.py``. Trains a short run
to a checkpoint (the quickstart recipe with checkpointing on, in a
temporary directory removed at exit), restores the parameters only into
an ``InferenceSession``, and fires a small query mix:

  * a **cold** batch: the full receptive-field plan, the cross-client
    embedding exchange at every aggregation layer, bytes metered per fresh
    row;
  * the same batch **warm**: every node hits the hot-node aggregate cache
    at the top layer, no exchange, zero wire bytes, bitwise-equal logits;
  * the cold mix again on an **int8-compressed** session from the same
    checkpoint: the same answers within the codec's tolerance, ~3x fewer
    bytes.

The micro-batcher at the end coalesces concurrent single-node requests
into one padded dispatch.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

import numpy as np

from ..api import ExperimentConfig, Trainer, get_preset
from ..serve import InferenceSession, MicroBatcher, ServeConfig


def config() -> ExperimentConfig:
    """The script's training run: ``cora-gcnii-glasu`` for 30 rounds, one
    exact eval at the end (the checkpoint directory is added by ``run``)."""
    return get_preset("cora-gcnii-glasu").with_(rounds=30, eval_every=30)


def run(cfg: ExperimentConfig, device=None) -> dict:
    """Train ``cfg`` to a checkpoint, serve it on ``device`` (default
    CUDA) and print the script's lines; returns their numbers."""
    ckpt_dir = tempfile.mkdtemp(prefix="glasu-serve-")
    try:
        trainer = Trainer(cfg.with_(ckpt_dir=ckpt_dir), device=device)
        try:
            trainer.run()
        finally:
            trainer.close()

        serve = ServeConfig(max_batch=16)
        session = InferenceSession.from_checkpoint(ckpt_dir, serve=serve,
                                                   device=device)
        rng = np.random.default_rng(0)
        nodes = rng.choice(session.N, size=16, replace=False)

        cold = session.answer(nodes)
        print(f"\ncold : {len(nodes)} nodes in "
              f"{cold.latency_s * 1e3:.1f} ms, {cold.wire_bytes} B on the "
              f"wire (fresh rows per agg layer: {cold.fresh_rows})")

        warm = session.answer(nodes)
        bitwise = bool(np.array_equal(cold.logits, warm.logits))
        print(f"warm : {warm.latency_s * 1e3:.1f} ms, {warm.wire_bytes} B "
              f"(cache hits {warm.cache_hits}/{len(nodes)}, bitwise equal: "
              f"{bitwise})")

        int8 = InferenceSession.from_checkpoint(
            ckpt_dir, serve=serve, compression={"method": "int8"},
            device=device)
        comp = int8.answer(nodes)
        agree = float((comp.preds == cold.preds).mean())
        print(f"int8 : {comp.wire_bytes} B "
              f"({cold.wire_bytes / comp.wire_bytes:.1f}x fewer), "
              f"prediction agreement {agree * 100:.0f}%")

        with MicroBatcher(session, deadline_ms=5.0) as mb:
            futs = [mb.submit([int(n)]) for n in nodes[:8]]
            preds = [int(f.result(timeout=30).preds[0]) for f in futs]
        print(f"batch: 8 single-node requests -> {mb.batches} dispatch(es), "
              f"preds {preds}")
        return dict(nodes=nodes, cold_bytes=cold.wire_bytes,
                    fresh_rows=dict(cold.fresh_rows),
                    cold_ms=cold.latency_s * 1e3, cold_preds=cold.preds,
                    warm_bytes=warm.wire_bytes,
                    warm_ms=warm.latency_s * 1e3, warm_hits=warm.cache_hits,
                    warm_bitwise=bitwise, int8_bytes=comp.wire_bytes,
                    int8_agreement=agree, batch_dispatches=mb.batches,
                    batch_preds=preds)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    return run(config(), args.device)


if __name__ == "__main__":
    main()
