#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device   the card's ``name, power.limit`` from nvidia-smi; TF32 off for
            matmuls and cuDNN, so every comparison is in full fp32;
2. build    compiles every kernel of the serving path from the sources in
            this checkout (``src/repro_torch/kernels/csrc``) and prints the
            build seconds and ptxas' register/shared-memory report;
3. kernels  holds each kernel against its plain PyTorch version on the card
            at the serving shapes of ``cora-gcnii-glasu`` and on ragged
            shapes, max abs error <= 1e-5 (fp32, fanout sums in another
            order), and times both with CUDA events (median of 30 after
            warm-up) beside the least time the card could take;
4. slice    serves ``cora-gcnii-glasu`` at full width (M = 3, L = 4,
            hidden 64, d_in 478) from seeded random parameters: a 16-query
            cold answer, the same query warm (bitwise equal, 0 wire bytes),
            ``precompute()`` and a fresh session's cold answer against the
            full-graph logits, and the same cold answer on the CPU (plain
            versions) at rtol = atol = 1e-4. The kernels' launch counters
            are zeroed just before this run and read just after it: the
            run fails if a kernel of the path was never launched;
5. result   one JSON line per kernel, then the final JSON line.

Any failure raises and exits non-zero; nothing is caught. Without CUDA, or
without the rest of the repository beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
KERNEL_ATOL = 1e-5
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)
# H100 SXM peaks at its full 700 W limit (NVIDIA's data sheet): device-memory
# rate and dense fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
REPS = 30
# ~2 ms of GPU spin before each timed call: longer than the host needs to
# enqueue the start event, the call's launches and the end event
SLEEP_CYCLES = 4_000_000


def _time_ms(torch, fn, reps=REPS, warmup=3, preload=True):
    """Median time of one ``fn`` call over ``reps`` (CUDA events).

    ``preload=True``: the stream is held busy (``torch.cuda._sleep``) while
    the host enqueues, so the interval is device time only. ``False``: the
    GPU is idle when the call starts, so the interval also holds the host's
    enqueue time (Python wrapper, checks, launch) — what a caller that
    waits on each call sees."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if preload:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _gcnii_bound(torch, h, h0, idx, mask, w, b):
    """(bound_ms, bound_by, bytes, flops) of one GCNII launch on these
    inputs: each input read once (of h and h0 only the rows the live fanout
    entries and the self column reference), the output written once; the
    gather, residual, matmul and epilogue flops the live entries need."""
    m, n_dst, f1 = idx.shape
    d = h.shape[2]
    live = mask != 0
    rows_h = sum(int(torch.unique(idx[c][live[c]]).numel()) for c in range(m))
    rows_h0 = sum(int(torch.unique(idx[c, :, 0]).numel()) for c in range(m))
    nbytes = ((rows_h + rows_h0) * d * 4 + idx.numel() * 4 + mask.numel() * 4
              + w.numel() * 4 + b.numel() * 4 + m * n_dst * d * 4)
    flops = (2 * int(live.sum()) * d        # masked gather-sum
             + 4 * m * n_dst * d            # mean, residual mix
             + 2 * m * n_dst * d * d        # z @ W
             + 5 * m * n_dst * d)           # identity map, bias, relu
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card)
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible")
    return card


def phase_build(build):
    t0 = time.perf_counter()
    results = build.build(["gcnii_layer"])
    total = time.perf_counter() - t0
    for r in results:
        state = f"{r.seconds:.2f} s" if r.seconds else "already built"
        print(f"build: {r.name} {state} -> {r.path.relative_to(ROOT)}")
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build:   {line.strip()}")
    print(f"build: total {total:.2f} s")


def _gcnii_inputs(torch, gen, m, n_src, n_dst, f1, d, case):
    h = torch.randn(m, n_src, d, generator=gen)
    h0 = torch.randn(m, n_src, d, generator=gen)
    idx = torch.randint(0, n_src, (m, n_dst, f1), generator=gen,
                        dtype=torch.int32)
    mask = (torch.rand(m, n_dst, f1, generator=gen) < 0.7).float()
    mask[:, :, 0] = 1.0                      # the plans' self column
    if case == "zero-mask rows":
        mask[:, ::4, :] = 0.0
    elif case == "mask[:,0]=0":
        mask[:, :, 0] = 0.0
    w = torch.randn(m, d, d, generator=gen) / d ** 0.5
    b = 0.1 * torch.randn(m, d, generator=gen)
    return [t.cuda() for t in (h, h0, idx, mask, w, b)]


def _compare(torch, graph_agg, args, kw):
    got = graph_agg.gcnii_layer_cuda(*args, **kw)
    torch.cuda.synchronize()
    want = graph_agg.gcnii_layer_plain(*args, **kw)
    if not torch.isfinite(got).all():
        raise AssertionError("gcnii_layer_cuda produced non-finite values")
    return float((got - want).abs().max())


def phase_kernels(torch, graph_agg):
    """Kernel vs plain on the serving shapes and ragged ones."""
    gen = torch.Generator().manual_seed(SEED)
    m, f1, d = 3, 33, 64
    cases = [
        # label, n_src, n_dst, d, case, beta
        ("serve l0", 2708, 2708, d, "", 0.5),
        ("serve l1", 2708, 2708, d, "", 0.5 / 2),
        ("serve l2", 2708, 1552, d, "", 0.5 / 3),
        ("serve l3", 1552, 16, d, "", 0.5 / 4),
        ("precompute", 2708, 4096, d, "", 0.5),
        ("d=24", 300, 200, 24, "", 0.5),
        ("n_dst=1", 2708, 1, d, "", 0.5),
        ("n_dst=1001 (ragged tile)", 2708, 1001, d, "", 0.5),
        ("zero-mask rows", 500, 300, d, "zero-mask rows", 0.5),
        ("mask[:,0]=0", 500, 300, d, "mask[:,0]=0", 0.5),
    ]
    worst = 0.0
    for label, n_src, n_dst, dd, case, beta in cases:
        args = _gcnii_inputs(torch, gen, m, n_src, n_dst, f1, dd, case)
        kw = dict(alpha=0.1, beta=beta)
        err = _compare(torch, graph_agg, args, kw)
        worst = max(worst, err)
        if err > KERNEL_ATOL:
            raise AssertionError(
                f"gcnii_layer_cuda vs plain at {label}: max abs err {err:.3e}"
                f" > {KERNEL_ATOL:.0e}")
        kernel = lambda: graph_agg.gcnii_layer_cuda(*args, **kw)
        k_ms = _time_ms(torch, kernel)
        launch_ms = _time_ms(torch, kernel, preload=False)
        p_ms = _time_ms(torch, lambda: graph_agg.gcnii_layer_plain(*args, **kw))
        bound_ms, bound_by, nbytes, flops = _gcnii_bound(torch, *args)
        print(f"kernels: gcnii_layer {label}: M={m} n_src={n_src} "
              f"n_dst={n_dst} d={dd} F+1={f1} max_abs_err={err:.3e} "
              f"kernel_ms={k_ms:.4f} launch_ms={launch_ms:.4f} "
              f"plain_ms={p_ms:.4f} "
              f"bound_us={bound_ms * 1e3:.3f} ({bound_by}; {nbytes} B, "
              f"{flops} flop) library_ms=null")
    print(f"kernels: gcnii_layer worst max_abs_err {worst:.3e} <= "
          f"{KERNEL_ATOL:.0e}; library_ms=null: no single PyTorch call "
          "computes the masked gather-mean, initial residual, matmul and "
          "relu together")


class _Capture:
    """Records the inputs of every ``ops.gcnii_layer`` call (cloned) while
    active, so the kernel can be timed on exactly what the main path gave
    it. Used on a separate warm-up session, outside the counted run."""

    def __init__(self, ops):
        self.ops, self.orig, self.calls = ops, ops.gcnii_layer, []

    def __enter__(self):
        def recording(*args, **kw):
            self.calls.append(([a.clone() for a in args], dict(kw)))
            return self.orig(*args, **kw)
        self.ops.gcnii_layer = recording
        return self

    def __exit__(self, *exc):
        self.ops.gcnii_layer = self.orig


def phase_slice(torch, np, mods):
    glasu, graph_agg, ops = mods["glasu"], mods["graph_agg"], mods["ops"]
    cfg = mods["get_preset"]("cora-gcnii-glasu")
    data = mods["make_vfl_dataset"](cfg.dataset, n_clients=cfg.n_clients,
                                    seed=cfg.seed)
    mcfg = cfg.glasu_config(data)
    width = (mcfg.n_clients, mcfg.n_layers, mcfg.hidden, mcfg.d_in,
             mcfg.n_classes, tuple(mcfg.agg_layers))
    if width != (3, 4, 64, 478, 7, (1, 3)):
        raise AssertionError(f"cora-gcnii-glasu is not at full width: {width}")
    params = glasu.init_params(torch.Generator().manual_seed(SEED), mcfg,
                               "cpu")
    serve = mods["ServeConfig"](max_batch=16)
    q = np.random.default_rng(SEED).choice(data.n_nodes, size=16,
                                           replace=False)

    def session(device):
        return mods["InferenceSession"](params, cfg, data, serve=serve,
                                        device=device)

    # warm-up session, outside the counted run: CUDA context, library
    # handles, and the main path's kernel inputs for the result line
    with _Capture(ops) as cap:
        s = session("cuda")
        s.answer(q)
        s.precompute()
    captured = cap.calls

    graph_agg.gcnii_layer_cuda.launches = 0           # ---- counted run
    sess = session("cuda")
    cold = sess.answer(q)
    per_cold = graph_agg.gcnii_layer_cuda.launches
    warm = sess.answer(q)
    full = sess.precompute()
    fresh = session("cuda").answer(q)
    launches = graph_agg.gcnii_layer_cuda.launches    # ---- read counts
    torch.cuda.synchronize()

    if per_cold < mcfg.n_layers:
        raise AssertionError(f"cold answer launched gcnii_layer_cuda "
                             f"{per_cold} times, expected >= {mcfg.n_layers}")
    if launches == 0:
        raise AssertionError("the main path never launched gcnii_layer_cuda")
    if cold.logits.shape != (16, mcfg.n_classes) or \
            not np.isfinite(cold.logits).all():
        raise AssertionError(f"bad cold logits {cold.logits.shape}")
    if not cold.cold or warm.cold or warm.wire_bytes != 0:
        raise AssertionError("the repeated query did not take the warm path "
                             f"(cold={warm.cold}, {warm.wire_bytes} B)")
    if not (np.array_equal(cold.logits, warm.logits)
            and np.array_equal(cold.per_client, warm.per_client)):
        raise AssertionError("warm logits are not bitwise equal to cold")
    if full.shape != (mcfg.n_clients, data.n_nodes, mcfg.n_classes):
        raise AssertionError(f"bad precompute logits {full.shape}")
    np.testing.assert_allclose(fresh.logits, full.mean(axis=0)[q],
                               **SLICE_TOL)
    print(f"slice: cora-gcnii-glasu M={mcfg.n_clients} L={mcfg.n_layers} "
          f"hidden={mcfg.hidden} d_in={mcfg.d_in} classes={mcfg.n_classes}"
          f" N={data.n_nodes}; gcnii_layer_cuda launches: {per_cold} per "
          f"cold answer, {launches} in the counted run (cold, warm, "
          "precompute, fresh cold)")
    print(f"slice: cold wire {cold.wire_bytes} B (fresh rows "
          f"{cold.fresh_rows}), warm wire {warm.wire_bytes} B, warm == cold "
          "bitwise; fresh cold vs full_forward max abs diff "
          f"{np.abs(fresh.logits - full.mean(axis=0)[q]).max():.3e}")

    cpu = session("cpu").answer(q)
    np.testing.assert_allclose(cold.logits, cpu.logits, **SLICE_TOL)
    np.testing.assert_allclose(cold.per_client, cpu.per_client, **SLICE_TOL)
    if (cpu.fresh_rows, cpu.wire_bytes) != (cold.fresh_rows, cold.wire_bytes):
        raise AssertionError("CPU and CUDA sessions billed different bytes")
    print(f"slice: CUDA vs CPU (plain) cold logits max abs diff "
          f"{np.abs(cold.logits - cpu.logits).max():.3e} "
          f"(rtol=atol={SLICE_TOL['atol']:.0e})")

    cold_ms, warm_ms = [], []
    for _ in range(20):
        sess.cache.clear()
        cold_ms.append(sess.answer(q).latency_s * 1e3)
    for _ in range(200):
        warm_ms.append(sess.answer(q).latency_s * 1e3)
    print(f"slice: 16-query answer latency cold median "
          f"{statistics.median(cold_ms):.3f} ms "
          f"({1e3 / statistics.mean(cold_ms):.1f} answers/s), warm median "
          f"{statistics.median(warm_ms):.3f} ms "
          f"({1e3 / statistics.mean(warm_ms):.1f} answers/s)")
    _cold_breakdown(torch, np, sess, q, glasu)
    return launches, captured


def _cold_breakdown(torch, np, sess, q, glasu):
    """Where one cold answer's time goes: host clock around its stages
    (medians of 20), then one answer under torch.profiler for the device's
    busy time."""
    uniq = np.unique(q)
    bucket = sess._bucket(len(uniq))
    no_hit = np.zeros(len(uniq), np.float32)
    no_rows = np.zeros((len(uniq), sess.M, sess.h_agg), np.float32)
    plan_ms, fwd_ms, d2h_ms = [], [], []
    with torch.inference_mode():
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = sess._build_plan(uniq, bucket, no_hit, no_rows)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            h, aggs = glasu.serve_forward(sess.params, plan.batch, sess.mcfg,
                                          cache_inject=plan.inject)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            h.cpu().numpy()
            for stack in aggs.values():
                stack.cpu().numpy()
            t3 = time.perf_counter()
            plan_ms.append((t1 - t0) * 1e3)
            fwd_ms.append((t2 - t1) * 1e3)
            d2h_ms.append((t3 - t2) * 1e3)
    print(f"slice: cold answer stages (host clock, medians of 20): plan "
          f"build + staging {statistics.median(plan_ms):.3f} ms, "
          f"serve_forward to sync {statistics.median(fwd_ms):.3f} ms, "
          f"copy-back {statistics.median(d2h_ms):.3f} ms")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sess.cache.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ans = sess.answer(q)
        torch.cuda.synchronize()
    # device-side activities only (kernels, memcpys): a CPU op's device
    # time is its children's, and summing both would count them twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    wall_us = ans.latency_s * 1e6
    print(f"slice: profiled cold answer: wall {wall_us / 1e3:.3f} ms (under "
          f"the profiler), device busy {busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / wall_us:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"slice:   device {e.self_device_time_total:9.1f} us x{e.count:<3d}"
              f" {e.key[:90]}")


def phase_result(torch, graph_agg, launches, captured, n_layers):
    """Times the kernel on the exact inputs the main path gave it: the
    layers of one cold answer, then those of precompute()."""
    per_launch = []
    for i, (args, kw) in enumerate(captured):
        err = _compare(torch, graph_agg, args, kw)
        if err > KERNEL_ATOL:
            raise AssertionError(f"main-path launch {i}: max abs err "
                                 f"{err:.3e} > {KERNEL_ATOL:.0e}")
        kernel = lambda: graph_agg.gcnii_layer_cuda(*args, **kw)
        k_ms = _time_ms(torch, kernel)
        launch_ms = _time_ms(torch, kernel, preload=False)
        p_ms = _time_ms(torch, lambda: graph_agg.gcnii_layer_plain(*args, **kw))
        bound_ms, bound_by, _, _ = _gcnii_bound(torch, *args)
        per_launch.append(dict(
            where="cold answer" if i < n_layers else "precompute",
            layer=i % n_layers, n_src=args[0].shape[1],
            n_dst=args[2].shape[1], max_abs_err=err, ms=k_ms,
            launch_ms=launch_ms, plain_ms=p_ms, bound_ms=bound_ms,
            bound_by=bound_by))
    cold = per_launch[:n_layers]
    by_bytes = sum(p["bound_ms"] for p in cold if p["bound_by"] == "bytes")
    by_ops = sum(p["bound_ms"] for p in cold) - by_bytes
    entry = dict(
        name="gcnii_layer", route="cuda",
        source="src/repro_torch/kernels/csrc/gcnii_layer.cu",
        replaces="src/repro/kernels/graph_agg.py:256",
        launches=launches,
        max_abs_err=max(p["max_abs_err"] for p in per_launch),
        ms=sum(p["ms"] for p in cold),
        launch_ms=sum(p["launch_ms"] for p in cold),
        plain_ms=sum(p["plain_ms"] for p in cold),
        bound_ms=sum(p["bound_ms"] for p in cold),
        bound_by="bytes" if by_bytes >= by_ops else "operations",
        library_ms=None,
        scope=f"sum over the {n_layers} launches of one 16-query cold "
              "answer (M=3, d=64, F+1=33); ms, plain_ms: device time; "
              "launch_ms: with the host's enqueue time; per_launch lists "
              "every captured main-path launch",
        per_launch=per_launch)
    print(json.dumps({"kernels": [entry]}))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU (CUDA)", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.api import get_preset
    from repro_torch.core import glasu
    from repro_torch.graph.synth import make_vfl_dataset
    from repro_torch.kernels import build, graph_agg, ops
    from repro_torch.serve import InferenceSession, ServeConfig

    phase_device(torch)
    phase_build(build)
    phase_kernels(torch, graph_agg)
    mods = dict(glasu=glasu, graph_agg=graph_agg, ops=ops,
                get_preset=get_preset, make_vfl_dataset=make_vfl_dataset,
                InferenceSession=InferenceSession, ServeConfig=ServeConfig)
    launches, captured = phase_slice(torch, np, mods)
    phase_result(torch, graph_agg, launches, captured,
                 get_preset("cora-gcnii-glasu").n_layers)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
