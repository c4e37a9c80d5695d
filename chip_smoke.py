#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device   the card's ``name, power.limit`` from nvidia-smi; TF32 off for
            matmuls and cuDNN, so every comparison is in full fp32;
2. build    compiles every kernel of the serving and training paths from
            the sources in this checkout (``src/repro_torch/kernels/csrc``,
            five sources, one nvcc each, all started together) and prints
            the build seconds and ptxas' register/shared-memory report;
            a graph kernel (GAT, GCNII, GCN, CSR) that spills registers
            fails the run;
3. kernels  holds each kernel (GCNII, GCN, GAT, CSR) against its plain
            PyTorch version on the card at the serving, training and eval
            shapes and on ragged and masked shapes (GCNII, GCN and GAT also
            at F+1 = 1 and 64, GAT at 17 and 32, a narrow head, fewer rows
            than a block, GCNII and GCN at d = 128 and n_dst = 16, all three
            with scalar columns and a W that is not 16-byte sized, GCN at
            the million-node training widths; for CSR: the million-node
            serving shape (also with its tiles shuffled, or its odd
            tiles), a planned ragged CSR with weights summing below 1, an
            empty graph, n_src = 16384, a hub tile, shuffled slabs, tiles
            of mixed order, a shuffled tile mostly of pads, two hub rows in
            one tile, ELL rows wholly masked, a slab past the kernel's
            8192-slot window, in row order and not, and a grid past what
            the card holds at once (the narrow build), each launched twice
            and held bitwise equal), max abs error <= 1e-5 (fp32,
            sums in another order), and times both with CUDA events
            (median of 30 after warm-up) beside the least time the card
            could take; then each op's gradients on the card against the
            CPU's at rtol = atol = 1e-4 (cuBLAS sums the backward's
            products in another order) and the backward's device time;
            the flash-attention kernel against
            its plain version on the reference's cases (four shapes causal
            and not, windows 32 / 128 / 511, dh 80 and 128) and on dh 40
            and 96, S and T that are multiples of no tile, and slices of a
            packed qkv tensor, each fp32 (the CUDA-core kernel) at 2e-5 and
            bf16 (the tensor-core kernel) at one bf16 rounding, |err| <=
            2^-7 |plain| + 1e-5; the constant-v property in both dtypes; the
            main-path shape (B 4, S = T = 4096, H 15, Kv 5, dh 64, bf16) at
            the same bound;
4. slice    serves ``cora-gcnii-glasu`` and ``cora-gat-glasu`` at full
            width (M = 3, L = 4, hidden 64, d_in 478) from seeded random
            parameters: a 16-query cold answer, the same query warm (bitwise
            equal, 0 wire bytes), ``precompute()`` and a fresh session's
            cold answer against the full-graph logits, and the same cold
            answer on the CPU (plain versions) at rtol = atol = 1e-4;
5. train    ``Trainer(get_preset(name)).run()`` for ``cora-gcn-glasu``,
            ``cora-gcnii-glasu`` and ``cora-gat-glasu`` at full width, 200
            rounds each (Alg 1, Q = 4, Adam): test accuracy >= 0.90 / 0.95 /
            0.65, comm bytes exactly 164,736,000, >= 20 launches a round of
            the preset's kernel and none of the others; 4 rounds from the
            same parameters and batches on the card and on the CPU; rounds/s
            on the host clock, where a round's time goes, and one profiled
            round's device-busy time and idle share; the batches come
            through the PrefetchSampler's worker thread (pinned host
            generations, non-blocking copies): its sampling, wait and copy
            ms a round, and 20 profiled rounds at prefetch_buffers 2 and 1
            with their idle share;
   comp     the cora hot shape of the reference's comm_compression bench
            (M 3, L 4, hidden 64, GCNII, batch 16, fanout 3, size cap 512,
            Adam, Q 1) for 60 rounds with an exact eval every 10, under no
            codec, int8, fp8 and top-k with error feedback at k = 8: each
            codec's bytes a round equal the reference's price, int8 cuts
            them >= 3x and top-k >= 6x, every final loss within 0.5 and val
            accuracy within 0.05 of the uncompressed run's; where a
            compressed round's time goes;
   fault    the same shape under the fault bench's DEADLINE_FAULTS (20 %
            drops, a 60 ms deadline, skewed latency), alone and with int8:
            val accuracy within 0.05 of the fault-free anchor, the bytes
            equal to the sum of the per-round delivered-only prices, the
            participation, catch-up count and virtual clock equal to a host
            replay of the schedule; where a fault round's time goes;
   resume   faults + int8 with error feedback: 40 rounds with a checkpoint
            every 20 (a temporary directory removed at exit), resumed to 60,
            against two uninterrupted 60-round runs: bitwise where those two
            agree bitwise, else within their distance;
   serve-comp cora-gcnii-glasu served with int8 and top-k at k = 8: the
            cold answer bills the reference session's bytes, the warm one is
            bitwise the cold one at 0 bytes, card vs CPU at the reference's
            COMP_TOL;
            the comp and fault phases also run the reference benches' meter
            audits on the port: each codec's sharded bind (collectives
            against the message log) and one simulated round agree on the
            bytes a round (``_audit_meters``), and 4 simulated fault rounds'
            logs price delivered and sent bytes as the analytic model
            (``_audit_fault_meters``);
   sim      ``cora-gcnii-glasu`` at full width on the simulation backend, 4
            SGD rounds against the vmapped engine from the same params and
            batches (the reference's SIM_TOL): the message log audited every
            round at the preset's 823,680 B, M·L + Q·L GCNII launches a
            round, rounds/s of both and a profiled round's idle share;
   sharded  the same preset on a one-rank NCCL client mesh (one card; the
            multi-rank collective is a CPU test over gloo; every backend,
            trainer and session closed after it, so the one-rank group
            is gone when the phase ends, else the run fails): 200 Trainer
            rounds (test accuracy >= 0.95, 164,736,000 B), the recorded
            collectives against the message log, where a round's time
            goes, 4 SGD rounds against vmapped (SHARD_TOL), and the sharded
            serve engine's 16-query answer cold and warm against the
            vmapped engine's (equal bills, the record_log replay);
6. powerlaw builds ``powerlaw-1m`` (2^20 nodes, its 268 MB feature file in
            a temporary directory removed at exit), trains
            ``powerlaw1m-gcn-glasu`` for its 50 rounds (finite losses, the
            reference's 422,400 comm bytes, no CSR launch) and serves the
            trained parameters from the streamed store: a cold 16-query
            answer is one CSR launch (layer 0, 67600 -> 1040 rows) and one
            GCN launch and bills the reference's 8320 B, its logits match
            the CPU session's; a 1-query answer makes no CSR launch; cold
            and warm latency, the plan build and store gather, and a
            profiled cold answer's device busy time and idle share;
7. serve    SmolLM-360M at its published widths (bf16, seed-0 weights),
            dense and GLASU-split (5 clients, sync every 2nd layer), through
            ``make_serve_step`` under inference mode: a B 4 x S 4096 prefill
            of TokenStream prompts with exactly 32 (dense) / 16 (GLASU) flash
            launches, cold and median time, tokens/s, its last-position
            logits against the same prefill through the plain version on
            the card, a profiled split into attention, the rest of the device
            time and the host; 32 greedy decode steps after the prompt
            (slots 4096..4127 of 4160-deep caches); decode against prefill in fp32 (B 2, 64-token prompt):
            argmax agreement >= 0.9, the last position exact;
   train_lm SmolLM-360M trained at its published widths (bf16, remat,
            AdamW, plain attention: the flash kernel has no backward, as
            the reference's has none) through ``make_train_step``: 10 steps
            on one B 4 x S 2048 TokenStream batch (finite losses, the last
            below the first, no kernel launch), cold and median step ms,
            tokens/s, peak device memory and a profiled step's idle share
            and top device ops; its GLASU split (5 clients, sync every 2nd
            layer, Q 4): 3 Q-step calls (12 microsteps, loss falling), the
            joint and stale microsteps' ms; phi3.5-moe at its published
            widths (d_model 4096, 32 / 8 heads of 128, 16 experts top-2 of
            6400, vocab 32064, grad_accum 4), 1 of 32 layers, 4 steps at B 8
            x S 1024 (aux > 0, the dropped fraction, peak memory); phi3.5-moe
            served at 2 layers through the flash kernel (a B 2 x S 2048
            prefill with exactly 2 launches, logits against the plain
            version at the serve phase's bound, layer 0's launch at one
            bf16 rounding and timed beside SDPA, 16 greedy decode steps);
            one fp32 train step each of reduced SmolLM, phi3.5-moe
            (grad_accum 2) and the SmolLM GLASU split (Q 3) on the card
            against the CPU: loss and every gradient at rtol = atol = 1e-4;
   families the five other transformer families at their published widths
            (bf16, seed-0 weights), one on the card at a time:
            deepseek-v2-lite (MLA + dense head + MoE), zamba2-1.2b (Mamba2
            + a shared attention block), rwkv6-7b, seamless-m4t-large-v2
            (encoder-decoder) and pixtral-12b (a 1024-patch prefix). Each
            served at full depth: a B 2 x S 2048 prefill with exactly 0 / 6
            / 0 / 48 / 40 flash launches, cold and median ms, its last-
            position logits against the plain version on the card (3e-2),
            the first flash launch timed beside SDPA, 16 greedy decode
            steps; each trained 3 AdamW steps at a depth cut to fit one card
            (finite losses, step ms, tokens/s, peak memory); then each
            reduced config in fp32 on the card against the CPU (prefill
            logits, one SGD step's loss and gradients, 1e-4);
8. flash32k one flash launch at the 32k serving shape (B 1, S 32768, H 15,
            Kv 5, dh 64, bf16) against the plain version (one bf16
            rounding, as on the main path), its bound and one
            ``scaled_dot_product_attention`` call (the yardstick, never
            called by the port);
9. result   the empty-launch floor (one PyTorch op on a one-element
            tensor, timed as the kernels are), each graph kernel's training
            and cold-answer launches one by one beside their sums, one JSON
            line listing every kernel, a ``time:`` line (main()'s host
            seconds, the build included, and each phase's), then the final
            JSON line.

Each path's launch counters are zeroed just before its counted run and read
just after it: the run fails if a kernel of the path was never launched.
Any failure raises and exits non-zero; nothing is caught. Without CUDA, or
without the rest of the repository beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
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
# card vs CPU gradients and SGD rounds: fp32 sums in another order (cuBLAS
# vs the CPU's BLAS, the kernels' fanout sums)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# Adam rounds card vs CPU: a near-zero gradient whose sign differs moves a
# parameter by up to 2·lr = 0.02 per step, so only the losses are held, at
# that order (the SGD rounds are the tight comparison)
ADAM_LOSS_TOL = dict(rtol=2e-2, atol=2e-2)
# presets whose free-running Adam rounds are chaotic, so their 4-round card
# vs CPU losses are reported and the re-synchronised rounds are held: on
# cora-gat-glasu (H100) the free-running gap reads 1.6e-3, 6.8e-3, 0.31 and
# 1.1 in rounds 1-4 while each round alone stays within 1.6e-3, and the
# reference's own 200-round Adam run climbs to a loss of 62.8 at round 100
ADAM_CHAOTIC = ("cora-gat-glasu",)
KERNEL_WRAPPERS = ("graph_agg_cuda", "gcnii_layer_cuda", "gat_layer_cuda",
                   "graph_agg_csr_cuda", "flash_attention_cuda")
# preset -> (its kernel's wrapper, least test accuracy). The reference
# reaches 0.934 / 0.989 on the first two (seed 0) and 0.693-0.809 on the GAT
# preset over seeds 0-4, its CPU runs; the port draws other initial
# parameters, so the GAT floor sits under the reference's worst seed
TRAIN_PRESETS = {"cora-gcn-glasu": ("graph_agg_cuda", 0.90),
                 "cora-gcnii-glasu": ("gcnii_layer_cuda", 0.95),
                 "cora-gat-glasu": ("gat_layer_cuda", 0.65)}
# served presets -> their kernel's wrapper
SERVE_PRESETS = {"cora-gcnii-glasu": "gcnii_layer_cuda",
                 "cora-gat-glasu": "gat_layer_cuda"}
TRAIN_ROUNDS = None          # None: the preset's own 200 rounds
TRAIN_COMM_BYTES = 164_736_000
# the million-node profile: the reference's comm bytes for the preset's 50
# rounds (its sampler's cost model, 8448 B a round; it depends on the
# layer sizes only) and its wire bill for a cold answer to np.arange(16) *
# 1000 (16 fresh rows at the one aggregation layer; it does not depend on
# the parameters), both computed with the JAX package on the CPU
POWERLAW_PRESET = "powerlaw1m-gcn-glasu"
POWERLAW_NODES = 1 << 20
POWERLAW_COMM_BYTES = 422_400
POWERLAW_WIRE_BYTES = 8320
POWERLAW_QUERY = tuple(range(0, 16000, 1000))
# the federated runtime's phases: the cora hot shape of the reference's
# benchmarks/comm_compression.py:50 and fault_bench.py:55 (Adam, Q = 1, lr
# 0.01), 60 rounds (their full mode), an exact eval every 10
COMP_HOT = dict(dataset="cora", n_clients=3, n_layers=4, hidden=64,
                backbone="gcnii", batch_size=16, fanout=3, size_cap=512)
COMP_ROUNDS, COMP_EVAL_EVERY = 60, 10
COMP_CODECS = (("none", None), ("int8", {"method": "int8"}),
               ("fp8", {"method": "fp8"}),
               ("topk_ef_k8", {"method": "topk_ef", "k": 8}))
# bytes a round under each codec: the reference's analytic price (its
# sampler's cost model at the codec's wire size; tests/test_torch_compression
# .py pins them), and the bench's gates
COMP_BYTES_PER_ROUND = {"none": 823_680, "int8": 228_096, "fp8": 215_424,
                        "topk_ef_k8": 114_048}
COMP_LOSS_SLACK, COMP_ACC_SLACK = 0.5, 0.05
# fault_bench.py:62-68: skewed latency (lognormal around 20 ms, a 15 %
# Pareto tail), a 20 % upload-drop rate and a 60 ms deadline
FAULT_LATENCY = dict(base_latency_ms=20.0, latency_sigma=0.5,
                     client_speed_sigma=0.2, straggler_prob=0.15,
                     straggler_scale=10.0, straggler_alpha=1.5)
DEADLINE_FAULTS = dict(seed=7, drop_prob=0.2, deadline_ms=60.0,
                       **FAULT_LATENCY)
RESUME_AT, RESUME_EVERY = 40, 20
# compressed serving of cora-gcnii-glasu: the reference session's bill for
# the 16-query cold answer (278 + 16 fresh rows; pinned by a CPU test), and
# the reference's tolerance between compressed implementations
# (tests/test_backend_conformance.py COMP_TOL)
SERVE_CODECS = (("int8", {"method": "int8"}),
                ("topk_ef_k8", {"method": "topk_ef", "k": 8}))
SERVE_WIRE_BYTES = {"int8": 123_480, "topk_ef_k8": 59_976}
COMP_TOL = dict(rtol=2e-4, atol=2e-4)
# the simulation and sharded backends (the reference's
# tests/test_backend_conformance.py classes): simulation vs vmapped is an
# independent per-client implementation (SIM_TOL), sharded vs vmapped the
# same engine over a gather (SHARD_TOL); both held on SGD rounds, as there.
# The card holds one GPU, so the sharded phases run one NCCL rank (m_loc =
# M); the cross-process collective is proven on the CPU (3 gloo ranks,
# tests/test_torch_sharded.py)
SIM_TOL = dict(rtol=2e-4, atol=2e-5)
SHARD_TOL = dict(rtol=5e-5, atol=5e-5)
BACKEND_PRESET = "cora-gcnii-glasu"
SIM_ROUNDS = 4
FAULT_AUDIT_ROUNDS = 4
# H100 SXM peaks at its full 700 W limit (NVIDIA's data sheet): device-memory
# rate and dense fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
REPS = 30
# sources whose kernels must not spill registers (ptxas -v, checked at
# build): the graph kernels, redesigned for latency
NO_SPILL_SOURCES = ("gat_layer", "gcnii_layer", "graph_agg", "graph_agg_csr")
BF16_FLOP_PER_S = 989e12          # dense bf16 on the tensor cores (700 W)
# flash kernel vs its plain version. fp32: the reference's flash tolerance
# (tests/test_kernels.py), sums in another order. bf16, every case: kernel
# and plain version both sum in fp32 and round once, so they differ by at
# most one bf16 step of |want| (<= 2^-7 of it), plus room for the fp32 sums'
# order (~1e-6); the reference's bf16 3e-2 is about a typical output's size
# at S = 4096 (~sqrt(e / S) = 0.03) and is used for no case
FLASH_F32_TOL = 2e-5
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2.0 ** -7, 1e-5
MAIN_FLASH_SHAPE = (4, 4096, 4096, 15, 5, 64)   # B, S, T, H, Kv, dh
FLASH_32K_SHAPE = (1, 32768, 15, 5, 64)         # B, S = T, H, Kv, dh
# prefill: train_4k's sequence length; prefill_32k (B 32, S 32768) cut to
# B 4, S 4096 (cut when the first, CUDA-core flash kernel had to fit the
# smoke's time; kept so runs compare)
PREFILL_B, PREFILL_S, PREFILL_REPS = 4, 4096, 5
DECODE_STEPS, DECODE_DEPTH = 32, 4160   # the steps fill slots 4096..4127
CONSIST_B, CONSIST_S = 2, 64      # decode vs prefill, fp32
# bf16 prefill, last-position logits through the kernel vs through the plain
# version on the card: each layer's attention output rounds to bf16 from
# fp32 values that differ in the last bits, and a flipped rounding travels
# through 32 bf16 layers; logits are below 1 in magnitude
PREFILL_LOGIT_ATOL = 3e-2
GEMM_WORDS = ("gemm", "xmma", "nvjet", "cutlass", "cublas")
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


def _gcn_bound(torch, h, idx, mask, w):
    """(bound_ms, bound_by, bytes, flops) of one GCN launch on these inputs:
    each input read once (of h only the rows live fanout entries
    reference), the output written once; the gather, mean and matmul
    flops the live entries need."""
    m, n_dst, f1 = idx.shape
    d, d_out = w.shape[1], w.shape[2]
    live = mask != 0
    rows_h = sum(int(torch.unique(idx[c][live[c]]).numel()) for c in range(m))
    nbytes = (rows_h * d * 4 + idx.numel() * 4 + mask.numel() * 4
              + w.numel() * 4 + m * n_dst * d_out * 4)
    flops = (2 * int(live.sum()) * d        # masked gather-sum
             + m * n_dst * d                # mean
             + 2 * m * n_dst * d * d_out)   # mean @ W
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def _gat_bound(torch, h, idx, mask, w, a_src, a_dst, b):
    """(bound_ms, bound_by, bytes, flops) of one GAT call on these inputs:
    each input read once (of h only the rows the live fanout entries and
    the self column reference), the output written once; the projection
    and scores of those rows, the logits, softmax and mask of every
    (row, entry, head), the weighted sum over the live entries, bias and
    elu."""
    m, n_dst, f1 = idx.shape
    d, heads = h.shape[2], w.shape[2]
    hd = heads * w.shape[3]
    live = mask > 0
    rows = sum(int(torch.unique(torch.cat([idx[c][live[c]], idx[c, :, 0]]))
                   .numel()) for c in range(m))
    nbytes = (rows * d * 4 + idx.numel() * 4 + mask.numel() * 4
              + (w.numel() + a_src.numel() + a_dst.numel() + b.numel()) * 4
              + m * n_dst * hd * 4)
    flops = (2 * rows * d * hd                # wh = h @ W
             + 4 * rows * hd                  # wh.a_src, wh.a_dst
             + 7 * m * n_dst * f1 * heads     # logit, leaky relu, mask,
                                              # max, exp, sum, divide + mask
             + 2 * int(live.sum()) * hd       # attention-weighted sum
             + 3 * m * n_dst * hd)            # bias, elu
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def _csr_bound(torch, h, idx_slab, seg_slab, ew_slab, w, n_dst, **_):
    """(bound_ms, bound_by, bytes, flops) of one CSR launch on these
    inputs: each slab read once, of h only the rows the live slots (seg in
    [0, 128), ew != 0) name, W once, the output written once; 2 flops a
    live slot and column for the weighted sum, one a live slot for the
    weight sum, a divide a row and column, and the (n_dst x d)(d x d_out)
    product."""
    m, _, d = h.shape
    d_out = w.shape[2]
    live = (seg_slab >= 0) & (seg_slab < 128) & (ew_slab != 0)
    rows_h = sum(int(torch.unique(idx_slab[c][live[c]]).numel())
                 for c in range(m))
    n_live = int(live.sum())
    nbytes = (rows_h * d * 4 + 3 * idx_slab.numel() * 4 + w.numel() * 4
              + m * n_dst * d_out * 4)
    flops = (2 * n_live * d + n_live + m * n_dst * d
             + 2 * m * n_dst * d * d_out)
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
    results = build.build(["gcnii_layer", "graph_agg", "gat_layer",
                           "graph_agg_csr", "flash_attention"])
    total = time.perf_counter() - t0
    for r in results:
        state = f"{r.seconds:.2f} s" if r.seconds else "already built"
        print(f"build: {r.name} {state} -> {r.path.relative_to(ROOT)}")
        for kernel, report in _ptxas_report(r.log):
            print(f"build:   {kernel}: {report}")
            if r.name in NO_SPILL_SOURCES and _spills(report):
                raise AssertionError(f"{r.name}: ptxas spills in {kernel} "
                                     f"({report})")
        if r.name in NO_SPILL_SOURCES and not r.seconds:
            print(f"build:   {r.name}: no ptxas report (built before this "
                  "run), spill check not made")
    print("build: flash_attention dynamic shared memory a block, as its "
          "launches request it: bf16 tensor-core kernel 5·64·(dh_pad + 8)·2"
          " B: " + ", ".join(f"dh_pad {d}: {5 * 64 * (d + 8) * 2} B"
                             for d in range(16, 129, 16))
          + "; fp32 CUDA-core kernel (196·dh_pad + 4352)·4 B: "
          + ", ".join(f"dh_pad {d}: {(196 * d + 4352) * 4} B"
                      for d in (32, 64, 96, 128)))
    print(f"build: total {total:.2f} s")


def _spills(report):
    """True when a ptxas report line shows any byte of spill stores or
    loads (a fresh build only: an already-built library has no log)."""
    return any(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                           report))


def _kernel_name(mangled):
    """The kernel's name and template integers from its Itanium-mangled
    name (``_ZN<len><id>...<len><id>ILi64EE...`` -> ``id<64>``)."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    args = re.findall(r"Li(\d+)E", mangled[i:].split("Ev")[0]) \
        if mangled[i:i + 1] == "I" else []
    return name + (f"<{', '.join(args)}>" if args else "")


def _ptxas_report(log):
    """[(kernel, "registers ...; spills ...")] for every instantiation in
    nvcc's -Xptxas -v log."""
    rows = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            rows.append((_kernel_name(m.group(1)), []))
        elif rows and ("registers" in line or "spill" in line):
            rows[-1][1].append(line.split("ptxas info    :")[-1].strip())
    return [(name, "; ".join(parts)) for name, parts in rows]


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
    """Max abs error of the kernel's output and saved z against the plain
    version; raises on non-finite output or if save=True changed it."""
    got, z = graph_agg.gcnii_layer_cuda(*args, **kw, save=True)
    out_only = graph_agg.gcnii_layer_cuda(*args, **kw)
    torch.cuda.synchronize()
    want, want_z = graph_agg.gcnii_layer_plain(*args, **kw, save=True)
    if not (torch.isfinite(got).all() and torch.equal(got, out_only)):
        raise AssertionError("gcnii_layer_cuda produced non-finite values, "
                             "or save=True changed the output")
    return max(float((got - want).abs().max()),
               float((z - want_z).abs().max()))


def phase_kernels(torch, graph_agg):
    """Kernel vs plain on the serving shapes and ragged ones."""
    gen = torch.Generator().manual_seed(SEED)
    m, d = 3, 64
    cases = [
        # label, n_src, n_dst, d, F+1, case, beta
        ("serve l0", 2708, 2708, d, 33, "", 0.5),
        ("serve l1", 2708, 2708, d, 33, "", 0.5 / 2),
        ("serve l2", 2708, 1552, d, 33, "", 0.5 / 3),
        ("serve l3", 1552, 16, d, 33, "", 0.5 / 4),
        ("precompute", 2708, 4096, d, 33, "", 0.5),
        ("d=24", 300, 200, 24, 33, "", 0.5),
        ("n_dst=1", 2708, 1, d, 33, "", 0.5),
        ("n_dst=1001 (ragged tile)", 2708, 1001, d, 33, "", 0.5),
        ("zero-mask rows", 500, 300, d, 33, "zero-mask rows", 0.5),
        ("mask[:,0]=0", 500, 300, d, 33, "mask[:,0]=0", 0.5),
        # the kernel's batch and block edges: self only, a fanout of four
        # whole batches, W of 64 KB (the shared-memory opt-in), the
        # training layer-3 destination count
        ("F+1=1 (self only)", 500, 300, d, 1, "", 0.5),
        ("F+1=64", 500, 300, d, 64, "", 0.5),
        ("d=128 (W 64 KB)", 500, 300, 128, 33, "", 0.5),
        ("n_dst=16", 64, 16, d, 4, "", 0.5 / 4),
        ("d=7 (scalar columns, W not 16-byte sized)", 100, 50, 7, 5, "", 0.5),
    ]
    worst = 0.0
    for label, n_src, n_dst, dd, f1, case, beta in cases:
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


def _gcn_inputs(torch, gen, m, n_src, n_dst, f1, d, d_out, case):
    h = torch.randn(m, n_src, d, generator=gen)
    idx = torch.randint(0, n_src, (m, n_dst, f1), generator=gen,
                        dtype=torch.int32)
    mask = (torch.rand(m, n_dst, f1, generator=gen) < 0.7).float()
    mask[:, :, 0] = 1.0                      # the plans' self column
    if case == "zero-mask rows":
        mask[:, ::4, :] = 0.0
    w = torch.randn(m, d, d_out, generator=gen) / d ** 0.5
    return [t.cuda() for t in (h, idx, mask, w)]


def phase_kernels_gcn(torch, graph_agg):
    """GCN kernel vs plain at the training, eval, concat and ragged
    shapes, the kernel's batch and block edges and the million-node
    training widths, forward with and without the saved mean."""
    gen = torch.Generator().manual_seed(SEED + 1)
    cases = [
        # label, M, n_src, n_dst, F+1, d, d_out, case
        ("train l0", 3, 512, 512, 4, 64, 64, ""),
        ("train l1", 3, 512, 512, 4, 64, 64, ""),
        ("train l2", 3, 512, 64, 4, 64, 64, ""),
        ("train l3", 3, 64, 16, 4, 64, 64, ""),
        ("eval", 3, 2708, 2708, 33, 64, 64, ""),
        ("concat d=192", 3, 512, 512, 4, 192, 64, ""),
        ("n_dst=1", 3, 512, 1, 4, 64, 64, ""),
        ("n_dst=1001 (ragged tile)", 3, 2708, 1001, 33, 64, 64, ""),
        ("zero-mask rows", 3, 500, 300, 4, 64, 64, "zero-mask rows"),
        # the kernel's batch and block edges: self only, four whole batches,
        # scalar columns with a W that is not 16-byte sized, W of 64 KB, the
        # fewest rows; the million-node preset's training widths
        ("F+1=1 (self only)", 3, 500, 300, 1, 64, 64, ""),
        ("F+1=64", 3, 500, 300, 64, 64, 64, ""),
        ("d=7 (scalar columns, W not 16-byte sized)", 3, 100, 50, 5, 7, 7,
         ""),
        ("d=128 (W 64 KB)", 3, 500, 300, 33, 128, 128, ""),
        ("n_dst=16", 3, 64, 16, 4, 64, 64, ""),
        ("powerlaw l0", 2, 256, 64, 4, 32, 32, ""),
        ("powerlaw l1", 2, 64, 16, 4, 32, 16, ""),
    ]
    worst = 0.0
    for label, m, n_src, n_dst, f1, d, d_out, case in cases:
        args = _gcn_inputs(torch, gen, m, n_src, n_dst, f1, d, d_out, case)
        got, mean = graph_agg.graph_agg_cuda(*args, save=True)
        plain_only = graph_agg.graph_agg_cuda(*args)
        torch.cuda.synchronize()
        want, want_mean = graph_agg.graph_agg_plain(*args, save=True)
        if not (torch.isfinite(got).all() and torch.equal(got, plain_only)):
            raise AssertionError(f"graph_agg_cuda at {label}: non-finite, or "
                                 "save=True changed the output")
        err = max(float((got - want).abs().max()),
                  float((mean - want_mean).abs().max()))
        worst = max(worst, err)
        if err > KERNEL_ATOL:
            raise AssertionError(
                f"graph_agg_cuda vs plain at {label}: max abs err {err:.3e}"
                f" > {KERNEL_ATOL:.0e}")
        kernel = lambda: graph_agg.graph_agg_cuda(*args)
        k_ms = _time_ms(torch, kernel)
        save_ms = _time_ms(torch, lambda: graph_agg.graph_agg_cuda(
            *args, save=True))
        launch_ms = _time_ms(torch, kernel, preload=False)
        p_ms = _time_ms(torch, lambda: graph_agg.graph_agg_plain(*args))
        bound_ms, bound_by, nbytes, flops = _gcn_bound(torch, *args)
        print(f"kernels: graph_agg {label}: M={m} n_src={n_src} "
              f"n_dst={n_dst} d={d} d_out={d_out} F+1={f1} "
              f"max_abs_err={err:.3e} kernel_ms={k_ms:.4f} "
              f"save_ms={save_ms:.4f} launch_ms={launch_ms:.4f} "
              f"plain_ms={p_ms:.4f} bound_us={bound_ms * 1e3:.3f} "
              f"({bound_by}; {nbytes} B, {flops} flop) library_ms=null")
    print(f"kernels: graph_agg worst max_abs_err {worst:.3e} <= "
          f"{KERNEL_ATOL:.0e}; library_ms=null: no single PyTorch call "
          "computes the masked gather-mean fused with @W (a sparse product "
          "needs the sparse matrix built from idx/mask first, then a second "
          "product)")


def _gat_inputs(torch, gen, m, n_src, n_dst, f1, d, heads, dh, case):
    h = torch.randn(m, n_src, d, generator=gen)
    idx = torch.randint(0, n_src, (m, n_dst, f1), generator=gen,
                        dtype=torch.int32)
    mask = (torch.rand(m, n_dst, f1, generator=gen) < 0.7).float()
    mask[:, :, 0] = 1.0                      # the plans' self column
    if case == "all-masked rows":
        mask[:, ::4, :] = 0.0                # softmax uniform, out = elu(b)
    elif case == "mask[:,0]=0":
        mask[:, :, 0] = 0.0                  # self score still read
    w = torch.randn(m, d, heads, dh, generator=gen) / d ** 0.5
    a_src = 0.1 * torch.randn(m, heads, dh, generator=gen)
    a_dst = 0.1 * torch.randn(m, heads, dh, generator=gen)
    b = 0.1 * torch.randn(m, heads * dh, generator=gen)
    return [t.cuda() for t in (h, idx, mask, w, a_src, a_dst, b)]


def phase_kernels_gat(torch, graph_agg):
    """GAT kernel vs plain at the training and eval shapes, the reference's
    four kernel-test shapes (heads 1/2/4, dh 8-64, ragged n_dst) and masked
    rows; every saved intermediate too, and save=False bitwise equal."""
    gen = torch.Generator().manual_seed(SEED + 4)
    m = 3
    cases = [
        # label, n_src, n_dst, F+1, d, heads, dh, case
        ("train l0", 512, 512, 4, 64, 2, 32, ""),
        ("train l1", 512, 512, 4, 64, 2, 32, ""),
        ("train l2", 512, 64, 4, 64, 2, 32, ""),
        ("train l3", 64, 16, 4, 64, 2, 32, ""),
        ("eval", 2708, 2708, 33, 64, 2, 32, ""),
        ("ref 64/32 H2 dh8", 64, 32, 5, 16, 2, 8, ""),
        ("ref 300/130 H2 dh32", 300, 130, 4, 64, 2, 32, ""),
        ("ref 256/77 H4 dh16", 256, 77, 5, 96, 4, 16, ""),
        ("ref 200/129 H1 dh64", 200, 129, 9, 48, 1, 64, ""),
        ("all-masked rows", 500, 300, 4, 64, 2, 32, "all-masked rows"),
        ("all-masked rows F+1=33", 2708, 300, 33, 64, 2, 32,
         "all-masked rows"),
        ("mask[:,0]=0", 500, 300, 33, 64, 2, 32, "mask[:,0]=0"),
        # the lane-group edges: self only (one lane a row), 17 (a group of
        # 32 lanes, two batches), 32 (a full warp), 64 (two entries a lane);
        # a narrow head; fewer destination rows than one block owns
        ("F+1=1 (self only)", 500, 300, 1, 64, 2, 32, ""),
        ("F+1=17", 500, 300, 17, 64, 2, 32, ""),
        ("F+1=32", 500, 300, 32, 64, 2, 32, ""),
        ("F+1=64", 500, 300, 64, 64, 2, 32, ""),
        ("H1 dh8", 300, 200, 5, 16, 1, 8, ""),
        ("n_dst=3", 64, 3, 4, 64, 2, 32, ""),
        ("d=7 H3 dh6 (scalar columns, W not 16-byte sized)", 120, 50, 5, 7,
         3, 6, ""),
    ]
    worst = 0.0
    for label, n_src, n_dst, f1, d, heads, dh, case in cases:
        args = _gat_inputs(torch, gen, m, n_src, n_dst, f1, d, heads, dh,
                           case)
        got = graph_agg.gat_layer_cuda(*args, save=True)
        out_only = graph_agg.gat_layer_cuda(*args)
        torch.cuda.synchronize()
        want = graph_agg.gat_layer_plain(*args, save=True)
        if not (torch.isfinite(got[0]).all()
                and torch.equal(got[0], out_only)):
            raise AssertionError(f"gat_layer_cuda at {label}: non-finite, or "
                                 "save=True changed the output")
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        worst = max(worst, err)
        if err > KERNEL_ATOL:
            raise AssertionError(
                f"gat_layer_cuda vs plain at {label}: max abs err {err:.3e}"
                f" > {KERNEL_ATOL:.0e} (out, wh, softmax, logits)")
        if case == "all-masked rows":
            elu_b = torch.nn.functional.elu(args[6])[:, None]
            if float((got[0][:, ::4] - elu_b).abs().max()) > KERNEL_ATOL:
                raise AssertionError(f"gat_layer_cuda at {label}: an "
                                     "all-masked row is not elu(b)")
        kernel = lambda: graph_agg.gat_layer_cuda(*args)
        k_ms = _time_ms(torch, kernel)
        save_ms = _time_ms(torch, lambda: graph_agg.gat_layer_cuda(
            *args, save=True))
        launch_ms = _time_ms(torch, kernel, preload=False)
        p_ms = _time_ms(torch, lambda: graph_agg.gat_layer_plain(*args))
        bound_ms, bound_by, nbytes, flops = _gat_bound(torch, *args)
        print(f"kernels: gat_layer {label}: M={m} n_src={n_src} "
              f"n_dst={n_dst} d={d} H={heads} dh={dh} F+1={f1} "
              f"max_abs_err={err:.3e} kernel_ms={k_ms:.4f} "
              f"save_ms={save_ms:.4f} launch_ms={launch_ms:.4f} "
              f"plain_ms={p_ms:.4f} bound_us={bound_ms * 1e3:.3f} "
              f"({bound_by}; {nbytes} B, {flops} flop) library_ms=null")
    print(f"kernels: gat_layer worst max_abs_err {worst:.3e} <= "
          f"{KERNEL_ATOL:.0e}; library_ms=null: {GAT_LIBRARY_NOTE}")


GAT_LIBRARY_NOTE = ("no single PyTorch call computes masked multi-head graph "
                    "attention with its projection (scaled_dot_product_"
                    "attention takes dense q/k/v and dot-product scores, not "
                    "a gathered fanout with additive leaky-relu scores)")
CSR_LIBRARY_NOTE = ("no single PyTorch call computes a weighted segment-mean "
                    "fused with @W; torch.sparse.mm of the row-normalised "
                    "adjacency then a matmul is two calls, timed as "
                    "sparse_mm_two_calls_ms and used nowhere in the port")


def _tile_perm(np, rng, n_tiles, slab, order):
    """Slot positions of a slab layout with the slots of every tile permuted
    (order "shuffled": pads among the live slots), of every odd tile only
    ("mixed") or none ("planned")."""
    perms = [rng.permutation(slab) for _ in range(n_tiles)]
    return np.concatenate([
        t * slab + (p if order == "shuffled" or (order == "mixed" and t % 2)
                    else np.arange(slab))
        for t, p in enumerate(perms)])


def _ell_inputs(torch, np, graph_agg, gen, m, n_src, n_dst, f1, case, order):
    """Random ELL tables (every row's first slot live, rows wholly masked
    for case "zero-mask rows") through ell_to_slabs, each client's slots
    then in ``order`` (see _tile_perm), with h and W (d = d_out = 32), on
    the card; and the (client, row) pairs with no live slot."""
    h, idx, mask, w = _gcn_inputs(torch, gen, m, n_src, n_dst, f1, 32, 32,
                                  case)
    slabs = graph_agg.ell_to_slabs(idx, mask)[:3]
    if order != "planned":
        n_tiles = -(-n_dst // 128)
        rng = np.random.default_rng(n_dst * m + f1)
        perm = torch.from_numpy(np.stack([
            _tile_perm(np, rng, n_tiles, slabs[0].shape[1] // n_tiles, order)
            for _ in range(m)])).cuda()
        slabs = [torch.gather(x, 1, perm) for x in slabs]
    return [h, *slabs, w], (mask.sum(dim=2) == 0).nonzero()


def _csr_inputs(torch, np, csr_plan, seed, n_dst, n_src, d, d_out, p_zero,
                hub, weights, order):
    """One client's planned slab layout of a ragged CSR (weights "none",
    "low": 0.05-0.3, so most rows sum below 1, or "rand": 0.25-1.25; order
    "planned", "shuffled": slots permuted within every tile, pads among the
    live slots, or "mixed": within every odd tile only), with h and W, on
    the card. ``hub``: row 0's degree, or a tuple of rows 0 and 3's."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 7, size=n_dst)
    deg[rng.random(n_dst) < p_zero] = 0
    for row, n in zip((0, 3), hub if isinstance(hub, tuple) else (hub,)):
        if n:
            deg[row] = n
    indptr = np.zeros(n_dst + 1, np.int32)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, n_src, size=int(indptr[-1])).astype(np.int32)
    lo, hi = {"none": (1.0, 1.0), "low": (0.05, 0.3),
              "rand": (0.25, 1.25)}[weights]
    ew = (lo + (hi - lo) * rng.random(len(indices))).astype(np.float32)
    slabs = csr_plan.plan_csr_slabs(indptr, indices, ew)[:3]
    if order != "planned":
        n_tiles = max(1, -(-n_dst // 128))
        perm = _tile_perm(np, rng, n_tiles, slabs[0].shape[0] // n_tiles,
                          order)
        slabs = [x[perm] for x in slabs]
    h = torch.from_numpy(rng.normal(size=(1, n_src, d)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(1, d, d_out)) / d ** 0.5)
                         .astype(np.float32))
    return ([h.cuda()]
            + [torch.from_numpy(np.ascontiguousarray(x[:, 0]))[None].cuda()
               for x in slabs]
            + [w.cuda()]), indptr, indices


def phase_kernels_csr(torch, np, graph_agg, csr_plan):
    """CSR kernel vs plain on the million-node serving shape (random ELL
    tables through ell_to_slabs; also with its tiles shuffled, or its odd
    tiles), planned layouts of ragged CSRs, an empty graph, n_src = 16384, a
    hub tile, shuffled slabs (pads among the live slots), tiles of mixed
    order, two hub rows in one tile, an ELL slab with whole rows masked, a
    slab past the kernel's shared-memory window and a grid past what the
    card holds at once (the narrow build); the saved mean too, save=False
    bitwise equal, two launches bitwise equal, rows with no (live) edge
    exactly 0."""
    gen = torch.Generator().manual_seed(SEED + 5)
    cases = [
        # label, M, n_src, n_dst, (F+1, mask case, order) (ELL) or (p_zero,
        # hub, weights, order) (planned CSR)
        ("serve l0 (ELL)", 2, 67600, 1040, (33, "", "planned")),
        # 18 tile slabs, 144 blocks of 16 rows: each warp sorts four rows
        ("serve l0 (ELL) shuffled", 2, 67600, 1040, (33, "", "shuffled")),
        ("serve l0 (ELL) mixed order", 2, 67600, 1040, (33, "", "mixed")),
        ("n_src=16384 (ELL)", 2, 16384, 300, (33, "", "planned")),
        ("ragged, weights below 1", 1, 5000, 1001,
         (0.3, 0, "low", "planned")),
        ("ragged, shuffled slabs", 1, 5000, 1001,
         (0.3, 0, "rand", "shuffled")),
        ("empty graph", 1, 100, 130, (1.0, 0, "none", "planned")),
        ("hub tile, slab > 128*33", 1, 67600, 200,
         (0.2, 6000, "rand", "planned")),
        ("hub tile shuffled", 1, 67600, 200,
         (0.2, 6000, "rand", "shuffled")),
        # tiles in row order beside shuffled ones; a shuffled tile that is
        # mostly pads; two hub rows in one block's rows; ELL rows whose
        # every slot has weight 0
        ("mixed order (odd tiles shuffled)", 1, 5000, 1001,
         (0.3, 0, "rand", "mixed")),
        ("shuffled, pads among live slots", 1, 5000, 300,
         (0.7, 0, "rand", "shuffled")),
        ("two hub rows in one tile", 1, 67600, 200,
         (0.2, (3000, 2000), "rand", "planned")),
        ("ELL, whole rows masked", 2, 16384, 300,
         (33, "zero-mask rows", "planned")),
        # a slab past the kernel's 8192-slot shared-memory window
        ("hub past one window (slab > 8192)", 1, 67600, 200,
         (0.2, 9000, "rand", "planned")),
        ("hub past one window shuffled", 1, 67600, 200,
         (0.2, 9000, "rand", "shuffled")),
        # 2 x 136 tiles x 8 blocks = 2176 blocks, more than the card holds
        # at once (16 blocks of 128 threads an SM x 132 SMs = 2112), so the
        # launch takes the narrow build
        ("narrow build (grid 2176 blocks)", 2, 20000, 17408,
         (4, "", "planned")),
        ("narrow build, mixed order", 2, 20000, 17408, (4, "", "mixed")),
    ]
    worst = 0.0
    for i, (label, m, n_src, n_dst, shape) in enumerate(cases):
        indptr = None
        if len(shape) == 3:
            args, zero = _ell_inputs(torch, np, graph_agg, gen, m, n_src,
                                     n_dst, *shape)
        else:
            args, indptr, _ = _csr_inputs(torch, np, csr_plan, SEED + 10 + i,
                                          n_dst, n_src, 32, 32, *shape)
            zero = torch.from_numpy(np.flatnonzero(np.diff(indptr) == 0))
            zero = torch.stack([torch.zeros_like(zero), zero], 1).cuda()
        got, mean = graph_agg.graph_agg_csr_cuda(*args, n_dst, save=True)
        out_only = graph_agg.graph_agg_csr_cuda(*args, n_dst)
        again = graph_agg.graph_agg_csr_cuda(*args, n_dst)
        torch.cuda.synchronize()
        want, want_mean = graph_agg.graph_agg_csr_plain(*args, n_dst,
                                                        save=True)
        if not (torch.isfinite(got).all() and torch.equal(got, out_only)):
            raise AssertionError(f"graph_agg_csr_cuda at {label}: "
                                 "non-finite, or save=True changed the output")
        if not torch.equal(again, out_only):
            raise AssertionError(f"graph_agg_csr_cuda at {label}: two "
                                 "launches on the same inputs differ")
        err = max(float((got - want).abs().max()),
                  float((mean - want_mean).abs().max()))
        worst = max(worst, err)
        if err > KERNEL_ATOL:
            raise AssertionError(
                f"graph_agg_csr_cuda vs plain at {label}: max abs err "
                f"{err:.3e} > {KERNEL_ATOL:.0e}")
        if not bool((got[zero[:, 0], zero[:, 1]] == 0).all()):
            raise AssertionError(f"graph_agg_csr_cuda at {label}: a row "
                                 "with no live edge is not exactly 0")
        kernel = lambda: graph_agg.graph_agg_csr_cuda(*args, n_dst)
        k_ms = _time_ms(torch, kernel)
        launch_ms = _time_ms(torch, kernel, preload=False)
        p_ms = _time_ms(torch, lambda: graph_agg.graph_agg_csr_plain(
            *args, n_dst))
        bound_ms, bound_by, nbytes, flops = _csr_bound(torch, *args, n_dst)
        print(f"kernels: graph_agg_csr {label}: M={m} n_src={n_src} "
              f"n_dst={n_dst} slab={args[1].shape[1] // max(1, -(-n_dst // 128))}"
              f" d=d_out=32 max_abs_err={err:.3e} kernel_ms={k_ms:.4f} "
              f"launch_ms={launch_ms:.4f} plain_ms={p_ms:.4f} "
              f"bound_us={bound_ms * 1e3:.3f} ({bound_by}; {nbytes} B, "
              f"{flops} flop) library_ms=null")
    print(f"kernels: graph_agg_csr worst max_abs_err {worst:.3e} <= "
          f"{KERNEL_ATOL:.0e}; library_ms=null: {CSR_LIBRARY_NOTE}")


def _sparse_mm_ms(torch, graph_agg, h, idx_slab, seg_slab, ew_slab, w, n_dst,
                  **_):
    """Device ms of torch.sparse.mm of the row-normalised adjacency built
    from the slabs (outside the timed region), then @W, every client: the
    two-call library yardstick of the CSR kernel."""
    rows = graph_agg.csr_rows(seg_slab, n_dst)
    _, wsum = graph_agg.csr_segment_sums(h, idx_slab, ew_slab, rows, n_dst)
    den = torch.clamp(wsum, min=1.0)
    mats = []
    for c in range(h.shape[0]):
        keep = rows[c] < n_dst
        r = rows[c][keep]
        vals = ew_slab[c][keep] / den[c][r]
        mats.append(torch.sparse_coo_tensor(
            torch.stack([r, idx_slab[c][keep].long()]), vals,
            (n_dst, h.shape[1]), check_invariants=True).coalesce())
    return _time_ms(torch, lambda: [torch.sparse.mm(a, h[c]) @ w[c]
                                    for c, a in enumerate(mats)])


def phase_grads(torch, ops):
    """Card vs CPU gradients of the three autograd Functions at the
    training shapes, and the explicit backward's device time."""
    gen = torch.Generator().manual_seed(SEED + 2)
    for label, n_src, n_dst in (("train l0", 512, 512),
                                ("train l2", 512, 64),
                                ("train l3", 64, 16)):
        h, idx, mask, w = _gcn_inputs(torch, gen, 3, n_src, n_dst, 4, 64, 64,
                                      "")
        h0 = torch.randn(3, n_src, 64, generator=gen).cuda()
        b = (0.1 * torch.randn(3, 64, generator=gen)).cuda()
        g = torch.randn(3, n_dst, 64, generator=gen).cuda()
        w4 = (torch.randn(3, 64, 2, 32, generator=gen) / 8.0).cuda()
        a_src, a_dst = (0.1 * torch.randn(2, 3, 2, 32, generator=gen)).cuda()
        ops_cases = {
            "graph_agg": (lambda t, i, k: ops.graph_agg(t[0], i, k, t[1]),
                          [h, w]),
            "gcnii_layer": (lambda t, i, k: ops.gcnii_layer(
                t[0], t[1], i, k, t[2], t[3], alpha=0.1, beta=0.25),
                [h, h0, w, b]),
            "gat_layer": (lambda t, i, k: ops.gat_layer(t[0], i, k, *t[1:]),
                          [h, w4, a_src, a_dst, b]),
        }
        for name, (fn, leaves) in ops_cases.items():
            grads = {}
            for dev in ("cuda", "cpu"):
                ts = [t.detach().to(dev).requires_grad_(True) for t in leaves]
                out = fn(ts, idx.to(dev), mask.to(dev))
                grads[dev] = [x.cpu() for x in
                              torch.autograd.grad(out, ts, g.to(dev))]
            errs = []
            for a_, b_ in zip(grads["cuda"], grads["cpu"]):
                torch.testing.assert_close(a_, b_, **GRAD_TOL)
                errs.append(float((a_ - b_).abs().max()))
            ts = [t.detach().requires_grad_(True) for t in leaves]
            out = fn(ts, idx, mask)
            bwd = lambda: torch.autograd.grad(out, ts, g, retain_graph=True)
            b_ms = _time_ms(torch, bwd)
            f_ms = _time_ms(torch, lambda: fn(ts, idx, mask))
            print(f"kernels: {name} backward {label}: n_src={n_src} "
                  f"n_dst={n_dst} d=64 card vs CPU max abs grad err "
                  f"{max(errs):.3e} (rtol=atol={GRAD_TOL['atol']:.0e}); "
                  f"device ms: forward with saved intermediate {f_ms:.4f}, "
                  f"backward {b_ms:.4f}")


def phase_grads_csr(torch, np, ops, csr_plan):
    """Card vs CPU gradients of ops.graph_agg_csr in h, w and the edge
    weights (degree-1 rows of weight 1 sit on the clamp's tie), and of
    ops.graph_agg at the CSR dispatch size in h and w; backward device
    time."""
    args, indptr, indices = _csr_inputs(torch, np, csr_plan, SEED + 20,
                                        1040, 5000, 32, 32, 0.3, 0, "rand",
                                        "planned")
    rng = np.random.default_rng(SEED + 21)
    ew = (0.25 + rng.random(len(indices))).astype(np.float32)
    ew[indptr[np.flatnonzero(np.diff(indptr) == 1)]] = 1.0
    g = torch.from_numpy(rng.normal(size=(1040, 32)).astype(np.float32))
    h, w = args[0][0].cpu(), args[4][0].cpu()
    m_, n_src = 2, 16384
    gen = torch.Generator().manual_seed(SEED + 22)
    hh, idx, mask, ww = _gcn_inputs(torch, gen, m_, n_src, 1040, 33, 32, 32,
                                    "")
    gg = torch.randn(m_, 1040, 32, generator=gen)
    cases = {
        "graph_agg_csr (h, w, edge_weight)": (
            lambda ts: ops.graph_agg_csr(ts[0], indptr, indices, ts[1],
                                         edge_weight=ts[2]),
            [h, w, torch.from_numpy(ew)], g),
        "graph_agg at n_src=16384, M=2 (h, w)": (
            lambda ts: ops.graph_agg(ts[0], idx.to(ts[0].device),
                                     mask.to(ts[0].device), ts[1]),
            [hh.cpu(), ww.cpu()], gg),
    }
    for name, (fn, leaves, cot) in cases.items():
        grads = {}
        for dev in ("cuda", "cpu"):
            ts = [t.detach().to(dev).requires_grad_(True) for t in leaves]
            out = fn(ts)
            grads[dev] = [x.cpu() for x in
                          torch.autograd.grad(out, ts, cot.to(dev))]
        errs = []
        for a_, b_ in zip(grads["cuda"], grads["cpu"]):
            torch.testing.assert_close(a_, b_, **GRAD_TOL)
            errs.append(float((a_ - b_).abs().max()))
        ts = [t.detach().cuda().requires_grad_(True) for t in leaves]
        out = fn(ts)
        cot = cot.cuda()
        b_ms = _time_ms(torch, lambda: torch.autograd.grad(
            out, ts, cot, retain_graph=True))
        f_ms = _time_ms(torch, lambda: fn(ts))
        print(f"kernels: {name} backward: card vs CPU max abs grad err "
              f"{max(errs):.3e} (rtol=atol={GRAD_TOL['atol']:.0e}); device "
              f"ms: forward with saved mean {f_ms:.4f}, backward {b_ms:.4f}")


class _Capture:
    """Records the inputs of every ``ops.<name>`` call (detached clones,
    the first ``limit``) while active, so a kernel can be timed on exactly
    what the main path gave it. Used on a separate warm-up run, outside
    the counted run."""

    def __init__(self, ops, name, limit=None):
        self.ops, self.name, self.limit = ops, name, limit
        self.orig, self.calls = getattr(ops, name), []

    def __enter__(self):
        def recording(*args, **kw):
            if self.limit is None or len(self.calls) < self.limit:
                self.calls.append(([a.detach().clone()
                                    if hasattr(a, "detach") else a
                                    for a in args], dict(kw)))
            return self.orig(*args, **kw)
        setattr(self.ops, self.name, recording)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.orig)


def _wrapper_fns(graph_agg):
    """Every kernel wrapper by name (the flash wrapper lives in its own
    module)."""
    from repro_torch.kernels import flash_attention
    return {name: getattr(flash_attention if name.startswith("flash")
                          else graph_agg, name)
            for name in KERNEL_WRAPPERS}


def _zero_counts(graph_agg):
    for fn in _wrapper_fns(graph_agg).values():
        fn.launches = 0


def _counts(graph_agg):
    return {name: fn.launches for name, fn in _wrapper_fns(graph_agg).items()}


def phase_slice(torch, np, mods, name, kernel_name):
    """Serves preset ``name`` through ``kernel_name``'s kernel."""
    glasu, graph_agg, ops = mods["glasu"], mods["graph_agg"], mods["ops"]
    cfg = mods["get_preset"](name)
    data = mods["make_vfl_dataset"](cfg.dataset, n_clients=cfg.n_clients,
                                    seed=cfg.seed)
    mcfg = cfg.glasu_config(data)
    width = (mcfg.n_clients, mcfg.n_layers, mcfg.hidden, mcfg.d_in,
             mcfg.n_classes, tuple(mcfg.agg_layers), mcfg.gat_heads)
    if width != (3, 4, 64, 478, 7, (1, 3), 2):
        raise AssertionError(f"{name} is not at full width: {width}")
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
    kernel = getattr(graph_agg, kernel_name)
    with _Capture(ops, kernel_name.replace("_cuda", "")) as cap:
        s = session("cuda")
        s.answer(q)
        s.precompute()
    captured = cap.calls

    _zero_counts(graph_agg)                           # ---- counted run
    sess = session("cuda")
    cold = sess.answer(q)
    per_cold = kernel.launches
    warm = sess.answer(q)
    full = sess.precompute()
    fresh = session("cuda").answer(q)
    counts = _counts(graph_agg)                       # ---- read counts
    torch.cuda.synchronize()
    launches = counts.pop(kernel_name)

    if per_cold < mcfg.n_layers:
        raise AssertionError(f"cold answer launched {kernel_name} "
                             f"{per_cold} times, expected >= {mcfg.n_layers}")
    if launches == 0 or any(counts.values()):
        raise AssertionError(f"serving {name}: {kernel_name} launched "
                             f"{launches} times, the others {counts}")
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
    print(f"slice: {name} M={mcfg.n_clients} L={mcfg.n_layers} "
          f"hidden={mcfg.hidden} d_in={mcfg.d_in} classes={mcfg.n_classes}"
          f" N={data.n_nodes}; {kernel_name} launches: {per_cold} per "
          f"cold answer, {launches} in the counted run (cold, warm, "
          f"precompute, fresh cold), the other kernels {counts}")
    print(f"slice: {name} cold wire {cold.wire_bytes} B (fresh rows "
          f"{cold.fresh_rows}), warm wire {warm.wire_bytes} B, warm == cold "
          "bitwise; fresh cold vs full_forward max abs diff "
          f"{np.abs(fresh.logits - full.mean(axis=0)[q]).max():.3e}")

    cpu = session("cpu").answer(q)
    np.testing.assert_allclose(cold.logits, cpu.logits, **SLICE_TOL)
    np.testing.assert_allclose(cold.per_client, cpu.per_client, **SLICE_TOL)
    if (cpu.fresh_rows, cpu.wire_bytes) != (cold.fresh_rows, cold.wire_bytes):
        raise AssertionError("CPU and CUDA sessions billed different bytes")
    print(f"slice: {name} CUDA vs CPU (plain) cold logits max abs diff "
          f"{np.abs(cold.logits - cpu.logits).max():.3e} "
          f"(rtol=atol={SLICE_TOL['atol']:.0e})")

    cold_ms, warm_ms = [], []
    for _ in range(20):
        sess.cache.clear()
        cold_ms.append(sess.answer(q).latency_s * 1e3)
    for _ in range(200):
        warm_ms.append(sess.answer(q).latency_s * 1e3)
    print(f"slice: {name} 16-query answer latency cold median "
          f"{statistics.median(cold_ms):.3f} ms "
          f"({1e3 / statistics.mean(cold_ms):.1f} answers/s), warm median "
          f"{statistics.median(warm_ms):.3f} ms "
          f"({1e3 / statistics.mean(warm_ms):.1f} answers/s)")
    _cold_breakdown(torch, np, sess, q, glasu, name)
    return launches, captured


def _cold_breakdown(torch, np, sess, q, glasu, name):
    """Where one cold answer's time goes: host clock around its stages
    (medians of 20), then one answer under torch.profiler for the device's
    busy time."""
    uniq = np.unique(q)
    bucket = sess._bucket(len(uniq))
    no_hit = np.zeros(len(uniq), np.float32)
    no_rows = np.zeros((len(uniq), sess.M, sess.h_agg), np.float32)
    plan_ms, fwd_ms, d2h_ms, gather_ms = [], [], [], []
    gather = sess._gather_feats

    def timed_gather(src0):
        t = time.perf_counter()
        out = gather(src0)
        gather_ms.append((time.perf_counter() - t) * 1e3)
        return out

    sess._gather_feats = timed_gather
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
    del sess._gather_feats
    print(f"slice: {name} cold answer stages (host clock, medians of 20): "
          f"plan "
          f"build + staging {statistics.median(plan_ms):.3f} ms ("
          + (f"of which the level-0 feature gather "
             f"{statistics.median(gather_ms):.3f} ms" if gather_ms else
             "level 0 is the identity set: resident features, no gather")
          + "), "
          f"serve_forward to sync {statistics.median(fwd_ms):.3f} ms, "
          f"copy-back {statistics.median(d2h_ms):.3f} ms")

    sess.cache.clear()
    ans, _, by_name, _ = _device_trace(torch, lambda: sess.answer(q))
    busy_us = sum(ns for ns, _ in by_name.values()) / 1e3
    wall_us = ans.latency_s * 1e6
    print(f"slice: {name} profiled cold answer: wall {wall_us / 1e3:.3f} ms "
          f"(under "
          f"the profiler), device busy {busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / wall_us:.3f} (device-only trace)")
    _print_top("slice:", by_name, 8, 90)


def _train_width(mcfg, sampler, cfg):
    return ((mcfg.n_clients, mcfg.n_layers, mcfg.hidden, mcfg.d_in,
             mcfg.n_classes, tuple(mcfg.agg_layers), mcfg.n_local_steps,
             mcfg.gat_heads),
            (cfg.optimizer, cfg.lr, cfg.batch_size, cfg.fanout,
             cfg.size_cap, list(sampler.layer_sizes)))


def _cpu_vs_card(torch, mods, cfg, trainer):
    """4 rounds from the same parameters and batches on the card and on
    the CPU: under SGD, free-running, held at GRAD_TOL; under the preset's
    Adam, free-running, losses held at ADAM_LOSS_TOL except for the presets
    of ADAM_CHAOTIC (reported only); and under Adam re-synchronised, each
    round started on both devices from the CPU's parameters and optimizer
    state, losses held at ADAM_LOSS_TOL."""
    glasu, tree_map = mods["glasu"], mods["tree_map"]
    mcfg = trainer.model_cfg
    p0 = glasu.init_params(torch.Generator().manual_seed(SEED + 3), mcfg,
                           "cpu")
    sampler = mods["GlasuSampler"](trainer.data, cfg.sampler_config(),
                                   seed=cfg.seed + 7)
    host = mods["sample_rounds"](sampler, 4)
    for opt_name in ("sgd", cfg.optimizer):
        optimizer = mods["make_optimizer"](opt_name, cfg.lr)
        step = glasu.make_multi_round_fn(mcfg, optimizer, 4)
        res = {}
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda t: t.to(dev), p0)
            p, _, losses = step(p, optimizer.init(p),
                                mods["batch_to_device"](host, dev))
            res[dev] = (mods["tree_leaves"](tree_map(lambda t: t.cpu(), p)),
                        losses.cpu())
        (pc, lc), (pp, lp) = res["cuda"], res["cpu"]
        loss_err = float((lc - lp).abs().max())
        param_err = max(float((a - b).abs().max()) for a, b in zip(pc, pp))
        held = opt_name == "sgd" or cfg.name not in ADAM_CHAOTIC
        if held:
            torch.testing.assert_close(
                lc, lp, **(GRAD_TOL if opt_name == "sgd" else ADAM_LOSS_TOL))
        if opt_name == "sgd":
            for a, b in zip(pc, pp):
                torch.testing.assert_close(a, b, **GRAD_TOL)
        per_round = [f"{float(x):.3e}" for x in (lc - lp).abs().amax(dim=1)]
        print(f"train: {cfg.name} 4 rounds card vs CPU ({opt_name}): losses "
              f"(4 x {mcfg.n_local_steps}) max abs diff {loss_err:.3e} (by "
              f"round {per_round}{'' if held else ', reported, not held'}),"
              f" params max abs diff {param_err:.3e}")
    _adam_resync(torch, mods, cfg, mcfg, p0, host)


def _adam_resync(torch, mods, cfg, mcfg, p0, host):
    """The preset's optimizer, one round at a time: each of the 4 rounds
    starts on the card and on the CPU from the CPU's parameters and
    optimizer state, so a round's error does not compound into the next."""
    tree_map = mods["tree_map"]
    optimizer = mods["make_optimizer"](cfg.optimizer, cfg.lr)
    round_fn = mods["glasu"].make_round_fn(mcfg, optimizer)
    params, state = p0, optimizer.init(p0)
    errs = []
    for i in range(4):
        batch = mods["unstack_round"](host, i)
        out = {}
        for dev in ("cuda", "cpu"):
            mv = lambda t, dev=dev: t.to(dev)
            out[dev] = round_fn(tree_map(mv, params),
                                type(state)(state.step, tree_map(mv, state.mu),
                                            tree_map(mv, state.nu)),
                                mods["batch_to_device"](batch, dev))
        lc, lp = out["cuda"][2].cpu(), out["cpu"][2]
        torch.testing.assert_close(lc, lp, **ADAM_LOSS_TOL)
        errs.append(float((lc - lp).abs().max()))
        params, state = out["cpu"][0], out["cpu"][1]
    print(f"train: {cfg.name} 4 rounds card vs CPU ({cfg.optimizer}, each "
          f"round from the CPU's state): losses max abs diff by round "
          f"{[f'{e:.3e}' for e in errs]} (rtol=atol="
          f"{ADAM_LOSS_TOL['atol']:.0e})")


def _round_breakdown(torch, mods, trainer, kernel, faults_fn=None):
    """Where a round's time goes on the host clock (medians of 20 rounds
    after the run): sampling, the copy to the card, the round to sync; the
    kernel's launches in one round; one round under torch.profiler for the
    device's busy time and idle share. ``faults_fn`` gives a fault run's
    next round's plans."""
    backend, st = trainer.backend, trainer.state
    kw = lambda: {} if faults_fn is None else {"faults": faults_fn()}
    params, opt_state = st.params, st.opt_state
    samp, copy, rnd = [], [], []
    for _ in range(20):
        t0 = time.perf_counter()
        host = mods["sample_rounds"](trainer.sampler, 1)
        t1 = time.perf_counter()
        batch = mods["batch_to_device"](host, "cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        kernel.launches = 0
        out = backend.run_step(params, opt_state, batch, **kw())
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        per_round = kernel.launches
        params, opt_state = out.params, out.opt_state
        samp.append((t1 - t0) * 1e3)
        copy.append((t2 - t1) * 1e3)
        rnd.append((t3 - t2) * 1e3)
    mcfg = trainer.model_cfg
    want = (1 + mcfg.n_local_steps) * mcfg.n_layers
    if per_round != want:
        raise AssertionError(f"one round launched {kernel.__name__} "
                             f"{per_round} times, expected {want}")
    med = statistics.median
    print(f"train: {trainer.cfg.name} round stages (host clock, medians of "
          f"20): sample {med(samp):.3f} ms, copy to card {med(copy):.3f} ms,"
          f" round (joint inference + {mcfg.n_local_steps} local steps) to "
          f"sync {med(rnd):.3f} ms; {per_round} {kernel.__name__} launches "
          "a round")

    _, wall_ms, by_name, _ = _device_trace(
        torch, lambda: backend.run_step(params, opt_state, batch, **kw()))
    wall_us = wall_ms * 1e3
    busy_us = sum(ns for ns, _ in by_name.values()) / 1e3
    print(f"train: {trainer.cfg.name} profiled round: wall "
          f"{wall_us / 1e3:.3f} ms (under the profiler), device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f} "
          f"(device-only trace), {sum(n for _, n in by_name.values())} "
          "device activities")
    _print_top("train:", by_name, 8, 90)
    return dict(sample_ms=med(samp), copy_ms=med(copy), round_ms=med(rnd),
                busy_ms=busy_us / 1e3, profiled_wall_ms=wall_us / 1e3,
                idle_share=1 - busy_us / wall_us)


def phase_train(torch, mods):
    """Trains every preset of TRAIN_PRESETS through the Trainer on the
    card."""
    graph_agg, ops = mods["graph_agg"], mods["ops"]
    out = {}
    for name, (kernel_name, min_acc) in TRAIN_PRESETS.items():
        cfg = mods["get_preset"](name)
        if TRAIN_ROUNDS is not None:
            cfg = cfg.with_(rounds=TRAIN_ROUNDS)
        op = kernel_name.replace("_cuda", "")
        kernel = getattr(graph_agg, kernel_name)
        # warm-up run, outside the counted run: CUDA context, library
        # handles, and the first joint inference's kernel inputs
        warm = mods["Trainer"](cfg.with_(rounds=1, eval_every=1))
        with _Capture(ops, op, limit=warm.model_cfg.n_layers) as cap:
            warm.run()
        torch.cuda.synchronize()

        _zero_counts(graph_agg)                          # ---- counted run
        trainer = mods["Trainer"](cfg)
        t0 = time.perf_counter()
        res = trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        others = _counts(graph_agg)                      # ---- read counts
        launches = others.pop(kernel_name)

        evals = [(e["round"], round(e["val_acc"], 4), round(e["test_acc"], 4))
                 for e in res.history]
        print(f"train: {name} M=3 L=4 hidden=64 d_in=478 classes=7 Q=4 "
              f"adam lr=0.01 batch 16 layer sizes "
              f"{trainer.sampler.layer_sizes}: {res.rounds_run} rounds in "
              f"{wall:.3f} s ({res.rounds_run / wall:.2f} rounds/s on the "
              f"host clock, {len(res.history)} exact evals included); test "
              f"acc {res.test_acc:.4f} (>= {min_acc}), val acc "
              f"{res.val_acc:.4f}, final loss {res.history[-1]['loss']:.4f},"
              f" comm {res.comm_bytes} B; {kernel_name} launches {launches},"
              f" the other kernels {others}")
        print(f"train: {name} evals (round, val acc, test acc): {evals}")
        width = _train_width(trainer.model_cfg, trainer.sampler, cfg)
        want_width = ((3, 4, 64, 478, 7, (1, 3), 4, 2),
                      ("adam", 0.01, 16, 3, 512, [512, 512, 512, 64, 16]))
        if width != want_width:
            raise AssertionError(f"{name} is not at full width: {width}")
        if res.rounds_run != cfg.rounds:
            raise AssertionError(f"{name} ran {res.rounds_run} rounds")
        if res.test_acc < min_acc:
            raise AssertionError(f"{name} test accuracy {res.test_acc:.4f} "
                                 f"< {min_acc}")
        if res.comm_bytes != TRAIN_COMM_BYTES:
            raise AssertionError(f"{name} metered {res.comm_bytes} B, "
                                 f"expected {TRAIN_COMM_BYTES}")
        if launches < 20 * cfg.rounds or any(others.values()):
            raise AssertionError(
                f"{name}: {kernel_name} launched {launches} times in "
                f"{cfg.rounds} rounds (want >= {20 * cfg.rounds}), the "
                f"other kernels {others} (want 0)")
        for leaf in mods["tree_leaves"](res.params):
            if leaf.device.type != trainer.device.type \
                    or not torch.isfinite(leaf).all():
                raise AssertionError(f"{name}: a trained parameter is not a "
                                     f"finite tensor on {trainer.device}")
        pf = trainer.prefetch_stats
        print(f"train: {name} prefetch (buffers {cfg.prefetch_buffers}, "
              f"{pf['rounds']} rounds): sample {pf['sample_ms']:.3f} ms a "
              f"round in the worker thread, consumer wait "
              f"{pf['wait_ms']:.3f} ms a round, pinned copy "
              f"{_ms(pf['copy_ms'])} a round (device)")
        _cpu_vs_card(torch, mods, cfg, trainer)
        stages = _round_breakdown(torch, mods, trainer, kernel)
        prefetch = _prefetch_profile(torch, mods, cfg, name)
        out[name] = dict(kernel=op, launches=launches, captured=cap.calls,
                         rounds=res.rounds_run, seconds=wall,
                         test_acc=res.test_acc, prefetch=prefetch, **stages)
    return out


def _ms(v):
    """A device time in ms, or "not measured" (no CUDA copy was timed)."""
    return "not measured" if v is None else f"{v:.3f} ms"


def _prefetch_profile(torch, mods, cfg, name):
    """20 rounds of ``cfg`` through the Trainer (its PrefetchSampler) at
    prefetch_buffers 2 and 1, each under torch.profiler: the worker's
    sampling ms a round, the consumer's wait, the copies' device ms a
    round, and the window's device-busy time and idle share."""
    out = {}
    for n_buf in (2, 1):
        trainer = mods["Trainer"](cfg.with_(rounds=20, eval_every=0,
                                            target_acc=None,
                                            prefetch_buffers=n_buf))
        _, wall_ms, by_name, _ = _device_trace(torch, trainer.run)
        wall_us = wall_ms * 1e3
        busy_us = sum(ns for ns, _ in by_name.values()) / 1e3
        st = trainer.prefetch_stats
        out[n_buf] = dict(st, idle_share=1 - busy_us / wall_us,
                          wall_ms_per_round=wall_us / 20e3)
        print(f"train: {name} prefetch_buffers {n_buf}: 20 profiled rounds, "
              f"sample {st['sample_ms']:.3f} ms a round (worker thread), "
              f"consumer wait {st['wait_ms']:.3f} ms a round, copy "
              f"{_ms(st['copy_ms'])} a round (device), wall "
              f"{wall_us / 20e3:.3f} ms a round under the profiler, device "
              f"busy {busy_us / 20e3:.3f} ms a round, idle share "
              f"{1 - busy_us / wall_us:.3f}")
    return out


# ------------------------------------------------- the federated runtime
def _hot_config(mods, **kw):
    """The reference benches' cora hot shape (Adam, Q = 1) with ``kw``."""
    return mods["ExperimentConfig"](
        name="fed-runtime", rounds=COMP_ROUNDS, eval_every=COMP_EVAL_EVERY,
        lr=0.01, **COMP_HOT).with_(**kw)


def _counted_run(torch, mods, cfg, data, start=0):
    """One Trainer run on the card, the launch counters zeroed just before
    it and read just after: fails unless the GCNII kernel launched at least
    (1 + Q)·L times a round run and no other kernel launched."""
    graph_agg = mods["graph_agg"]
    _zero_counts(graph_agg)                          # ---- counted run
    trainer = mods["Trainer"](cfg, data=data)
    t0 = time.perf_counter()
    res = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(graph_agg)                      # ---- read counts
    launches = counts.pop("gcnii_layer_cuda")
    mcfg = trainer.model_cfg
    want = (1 + mcfg.n_local_steps) * mcfg.n_layers * (res.rounds_run - start)
    if launches < want or any(counts.values()):
        raise AssertionError(f"{cfg.name}: gcnii_layer_cuda launched "
                             f"{launches} times (want >= {want}), the other "
                             f"kernels {counts}")
    for leaf in mods["tree_leaves"](res.params):
        if leaf.device.type != trainer.device.type \
                or not torch.isfinite(leaf).all():
            raise AssertionError(f"{cfg.name}: a trained parameter is not a "
                                 f"finite tensor on {trainer.device}")
    return res, trainer, wall, launches


def phase_comp_train(torch, mods, data):
    """The cora hot shape trained 60 rounds under each codec, held to the
    reference bench's gates and to the reference's bytes a round."""
    results, trainers = {}, {}
    for label, cc in COMP_CODECS:
        cfg = _hot_config(mods, name=f"comm-{label}", compression=cc)
        res, trainer, wall, launches = _counted_run(torch, mods, cfg, data)
        per_round = res.comm_bytes // res.rounds_run
        if res.comm_bytes != COMP_BYTES_PER_ROUND[label] * COMP_ROUNDS:
            raise AssertionError(
                f"{label}: {res.comm_bytes} B in {res.rounds_run} rounds, "
                f"expected {COMP_BYTES_PER_ROUND[label]} a round")
        results[label] = dict(bytes_per_round=per_round,
                              final_loss=res.history[-1]["loss"],
                              val_acc=res.val_acc, test_acc=res.test_acc,
                              rounds_per_s=res.rounds_run / wall,
                              launches=launches)
        trainers[label] = trainer
    dense = results["none"]
    for label, r in results.items():
        r["reduction"] = dense["bytes_per_round"] / r["bytes_per_round"]
        print(f"comp: {label} {r['bytes_per_round']} B a round (the "
              f"reference's price), {r['reduction']:.2f}x fewer than none; "
              f"final loss {r['final_loss']:.4f}, val acc {r['val_acc']:.4f}"
              f", test acc {r['test_acc']:.4f}; {COMP_ROUNDS} rounds at "
              f"{r['rounds_per_s']:.2f} rounds/s (host clock, "
              f"{COMP_ROUNDS // COMP_EVAL_EVERY} exact evals included); "
              f"gcnii_layer_cuda launches {r['launches']}")
    gates = [("int8 cuts bytes a round >= 3x",
              results["int8"]["reduction"] >= 3.0),
             ("topk_ef_k8 cuts bytes a round >= 6x",
              results["topk_ef_k8"]["reduction"] >= 6.0)]
    for label, r in results.items():
        gates.append((f"{label} final loss <= none + {COMP_LOSS_SLACK}",
                      r["final_loss"] <= dense["final_loss"]
                      + COMP_LOSS_SLACK))
        gates.append((f"{label} val acc >= none - {COMP_ACC_SLACK}",
                      r["val_acc"] >= dense["val_acc"] - COMP_ACC_SLACK))
    failed = [g for g, ok in gates if not ok]
    if failed:
        raise AssertionError(f"compression gates failed: {failed}")
    print(f"comp: gates passed ({len(gates)}): " + "; ".join(
        g for g, _ in gates))
    for label, cc in COMP_CODECS:
        audited = _audit_meters(torch, mods, _hot_config(
            mods, name=f"comm-{label}", compression=cc), data)
        if audited != COMP_BYTES_PER_ROUND[label]:
            raise AssertionError(f"{label}: the audited meters give "
                                 f"{audited} B a round")
        print(f"comp: {label} audit (benchmarks/comm_compression.py "
              f"_audit_meters): the sharded bind's collectives == one "
              f"simulated round's upload + broadcast payloads, both meters "
              f"{audited} B a round")
    for label in ("none", "int8", "topk_ef_k8"):
        _round_breakdown(torch, mods, trainers[label],
                         mods["graph_agg"].gcnii_layer_cuda)
    return results


def _fault_replay(mods, cfg, sampler, rounds):
    """The fault schedule replayed on the host (numpy, so exactly the
    Trainer's draw): delivered-only bytes, and ParticipationHook's running
    participation, catch-ups and virtual clock after ``rounds`` rounds."""
    plans = mods["FaultSchedule"](cfg.faults, cfg.n_clients).draw_step(
        rounds)
    comp = mods["make_compressor"](cfg.compression)
    bytes_ = sum(sampler.comm_bytes_per_joint_inference(
        cfg.hidden, cfg.agg, compressor=comp, n_uploads=p.n_present)
        for p in plans)
    presence = 0.0
    for p in plans:
        presence += p.n_present / len(p.present)
    return dict(comm_bytes=bytes_, participation=presence / rounds,
                catch_up_rounds=sum(bool(p.catch_up) for p in plans),
                virtual_ms=plans[-1].t_end,
                delivered=sum(p.n_present for p in plans))


def phase_fault_train(torch, mods, data, anchor):
    """The hot shape under DEADLINE_FAULTS, alone and composed with int8:
    accuracy against the fault-free anchor, bytes and participation against
    a host replay of the same schedule."""
    out = {}
    for label, cc in (("deadline", None),
                      ("deadline+int8", {"method": "int8"})):
        cfg = _hot_config(mods, name=f"fault-{label}",
                          faults=DEADLINE_FAULTS, compression=cc)
        res, trainer, wall, launches = _counted_run(torch, mods, cfg, data)
        want = _fault_replay(mods, cfg, trainer.sampler, COMP_ROUNDS)
        last = res.history[-1]
        got = dict(comm_bytes=res.comm_bytes,
                   participation=last["participation"],
                   catch_up_rounds=last["catch_up_rounds"],
                   virtual_ms=last["virtual_ms"])
        for k, v in got.items():
            if v != want[k]:
                raise AssertionError(f"{label}: {k} {v} != the host "
                                     f"replay's {want[k]}")
        if res.val_acc < anchor["val_acc"] - COMP_ACC_SLACK:
            raise AssertionError(
                f"{label}: val acc {res.val_acc:.4f} more than "
                f"{COMP_ACC_SLACK} below the fault-free anchor "
                f"{anchor['val_acc']:.4f}")
        out[label] = dict(got, val_acc=res.val_acc,
                          rounds_per_s=res.rounds_run / wall)
        print(f"fault: {label} {COMP_ROUNDS} rounds: val acc "
              f"{res.val_acc:.4f} (fault-free anchor "
              f"{anchor['val_acc']:.4f}, >= anchor - {COMP_ACC_SLACK}), "
              f"test acc {res.test_acc:.4f}, final loss "
              f"{last['loss']:.4f}; bytes {res.comm_bytes} == the sum of the"
              f" per-round delivered-only prices ({want['delivered']} of "
              f"{3 * COMP_ROUNDS} uploads delivered); participation "
              f"{got['participation']:.6f}, catch-up rounds "
              f"{got['catch_up_rounds']}, virtual clock "
              f"{got['virtual_ms']:.3f} ms, each == the host replay of the "
              f"schedule; {res.rounds_run / wall:.2f} rounds/s; "
              f"gcnii_layer_cuda launches {launches}")
        audited, n_present, n_att = _audit_fault_meters(torch, mods, cfg,
                                                        data)
        print(f"fault: {label} audit (benchmarks/fault_bench.py "
              f"_audit_fault_meters): {FAULT_AUDIT_ROUNDS} simulated rounds, "
              f"each message log's delivered and sent bytes == the analytic "
              f"model ({n_present} of {n_att} attempted uploads delivered, "
              f"{audited} B delivered)")
        sched = mods["FaultSchedule"](cfg.faults, cfg.n_clients)
        _round_breakdown(torch, mods, trainer,
                         mods["graph_agg"].gcnii_layer_cuda,
                         faults_fn=lambda sched=sched: sched.draw_step(1))
    return out


def phase_resume(torch, mods, data):
    """Faults + int8 with error feedback: 40 rounds with a checkpoint every
    20 (a temporary directory, removed at exit), a resume to 60, and two
    uninterrupted 60-round runs. If those two agree bitwise the resumed run
    must equal them bitwise, else lie within their distance."""
    import shutil
    import tempfile
    cfg = _hot_config(mods, name="fed-resume", faults=DEADLINE_FAULTS,
                      compression={"method": "int8", "error_feedback": True})
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ck = cfg.with_(ckpt_dir=root, ckpt_every=RESUME_EVERY)
        mods["Trainer"](ck.with_(rounds=RESUME_AT), data=data).run()
        saved = sorted(p.name for p in Path(root).iterdir())
        res, resumed, _, launches = _counted_run(torch, mods, ck, data,
                                                 start=RESUME_AT)
        if not (resumed.sampler_restored and resumed.fault_sched_restored):
            raise AssertionError("the resume did not restore the sampler "
                                 "and fault-schedule states")
    finally:
        shutil.rmtree(root)
    runs = [mods["Trainer"](cfg, data=data).run() for _ in range(2)]
    leaves = [[t.cpu() for t in mods["tree_leaves"](r.params)]
              for r in (res, *runs)]
    dist = lambda a, b: max(float((x - y).abs().max()) for x, y in zip(a, b))
    between, off = dist(leaves[1], leaves[2]), dist(leaves[0], leaves[1])
    if res.comm_bytes != runs[0].comm_bytes or \
            runs[0].comm_bytes != runs[1].comm_bytes:
        raise AssertionError(f"resume bytes {res.comm_bytes} vs "
                             f"{[r.comm_bytes for r in runs]}")
    if between == 0.0:
        case = "the two uninterrupted runs agree bitwise"
        if off != 0.0:
            raise AssertionError(f"the resumed run is {off:.3e} from the "
                                 "uninterrupted runs, which agree bitwise")
    else:
        case = (f"the two uninterrupted runs differ by {between:.3e} (max "
                "abs over the parameters)")
        if off > between:
            raise AssertionError(f"the resumed run is {off:.3e} from an "
                                 f"uninterrupted run, more than {between:.3e}")
    print(f"resume: faults + int8 (error feedback) at the hot shape: "
          f"{RESUME_AT} rounds with a checkpoint every {RESUME_EVERY} "
          f"({', '.join(saved)}), resumed to {COMP_ROUNDS}: sampler and "
          f"fault schedule restored; {case}; resumed vs uninterrupted max "
          f"abs {off:.3e} ({'bitwise' if off == 0.0 else 'within'}); bytes "
          f"{res.comm_bytes} in all three; gcnii_layer_cuda launches "
          f"{launches} in the resumed run")
    return dict(between=between, resumed_off=off, case=case)


def phase_comp_serve(torch, np, mods):
    """cora-gcnii-glasu served through each codec of SERVE_CODECS at full
    width from seeded parameters: the cold answer bills the reference
    session's bytes, the warm answer is bitwise the cold one at 0 bytes,
    and the cold answer matches the CPU session's at COMP_TOL."""
    glasu, graph_agg = mods["glasu"], mods["graph_agg"]
    cfg = mods["get_preset"]("cora-gcnii-glasu")
    data = mods["make_vfl_dataset"](cfg.dataset, n_clients=cfg.n_clients,
                                    seed=cfg.seed)
    mcfg = cfg.glasu_config(data)
    params = glasu.init_params(torch.Generator().manual_seed(SEED), mcfg,
                               "cpu")
    serve = mods["ServeConfig"](max_batch=16)
    q = np.random.default_rng(SEED).choice(data.n_nodes, size=16,
                                           replace=False)
    out = {}
    for label, cc in SERVE_CODECS:
        def session(device, cc=cc):
            return mods["InferenceSession"](params, cfg, data, serve=serve,
                                            compression=cc, device=device)
        session("cuda").answer(q)                    # warm-up
        _zero_counts(graph_agg)                          # ---- counted run
        sess = session("cuda")
        cold = sess.answer(q)
        warm = sess.answer(q)
        counts = _counts(graph_agg)                      # ---- read counts
        launches = counts.pop("gcnii_layer_cuda")
        if launches < mcfg.n_layers or any(counts.values()):
            raise AssertionError(f"compressed serving ({label}): "
                                 f"gcnii_layer_cuda {launches}, the others "
                                 f"{counts}")
        if cold.wire_bytes != SERVE_WIRE_BYTES[label]:
            raise AssertionError(f"{label}: cold answer billed "
                                 f"{cold.wire_bytes} B, the reference "
                                 f"{SERVE_WIRE_BYTES[label]}")
        if not cold.cold or warm.cold or warm.wire_bytes != 0 or not (
                np.array_equal(cold.logits, warm.logits)
                and np.array_equal(cold.per_client, warm.per_client)):
            raise AssertionError(f"{label}: the warm answer is not bitwise "
                                 "the cold one at 0 bytes")
        cpu = session("cpu").answer(q)
        np.testing.assert_allclose(cold.logits, cpu.logits, **COMP_TOL)
        np.testing.assert_allclose(cold.per_client, cpu.per_client,
                                   **COMP_TOL)
        cold_ms = []
        for _ in range(10):
            sess.cache.clear()
            cold_ms.append(sess.answer(q).latency_s * 1e3)
        err = float(np.abs(cold.per_client - cpu.per_client).max())
        out[label] = dict(wire_bytes=cold.wire_bytes, err=err,
                          cold_ms=statistics.median(cold_ms))
        print(f"serve-comp: cora-gcnii-glasu {label}: cold wire "
              f"{cold.wire_bytes} B (== the reference session's bill; "
              f"fresh rows {cold.fresh_rows}), warm 0 B and bitwise the cold"
              f" answer; card vs CPU (plain) per-client logits max abs "
              f"{err:.3e} (rtol=atol={COMP_TOL['atol']:.0e}); cold median "
              f"{statistics.median(cold_ms):.3f} ms; gcnii_layer_cuda "
              f"launches {launches} (cold, warm)")
    return out


# ------------------------------------- the simulation and sharded backends
def _sgd_rounds(torch, mods, backend, mcfg, sampler, p0, host, lr, **kw):
    """``backend`` bound to ``mcfg`` runs the rounds of ``host`` one at a
    time under SGD on the card from ``p0``: (params, losses (K, Q), the
    per-round bytes, the GCNII launches, host seconds to sync)."""
    graph_agg = mods["graph_agg"]
    opt = mods["make_optimizer"]("sgd", lr)
    backend.bind(mcfg, opt, sampler)
    params = mods["tree_map"](lambda t: t.to("cuda", copy=True), p0)
    state = opt.init(params)
    batch = mods["batch_to_device"](host, "cuda")
    torch.cuda.synchronize()
    before = graph_agg.gcnii_layer_cuda.launches
    t0 = time.perf_counter()
    out = mods["run_step_sequential"](backend, params, state, batch, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    backend.close()
    return (out.params, out.losses, out.comm_bytes_rounds
            or (out.comm_bytes_round,) * host.labels.shape[0],
            graph_agg.gcnii_layer_cuda.launches - before, wall,
            out.message_logs)


def _turns(torch, mods, name, first, vmapped, mcfg, sampler, p0, host, lr):
    """Mean host seconds of ``name``'s and the vmapped backend's runs of
    ``host``, timed in turns: ``first`` and ``vmapped`` ran already, then
    vmapped and ``name`` once more."""
    kw = {"device": "cuda"} if name == "sharded" else {}
    vm2 = _sgd_rounds(torch, mods, mods["make_backend"]("vmapped"), mcfg,
                      sampler, p0, host, lr)
    again = _sgd_rounds(torch, mods, mods["make_backend"](name, **kw), mcfg,
                        sampler, p0, host, lr)
    return (first[4] + again[4]) / 2, (vmapped[4] + vm2[4]) / 2


def _max_diff(torch, a, b):
    return max(float((x - y).abs().max())
               for x, y in zip(a, b)) if a else 0.0


def _profiled_round(torch, fn):
    """One call of ``fn`` under ``_device_trace``: (wall ms, device busy
    ms, idle share)."""
    _, wall_ms, by_name, _ = _device_trace(torch, fn)
    busy_ms = sum(ns for ns, _ in by_name.values()) / 1e6
    return wall_ms, busy_ms, 1 - busy_ms / wall_ms


def phase_sim(torch, mods):
    """SIM_ROUNDS rounds of BACKEND_PRESET at full width on the simulation
    backend against the vmapped engine from the same params and batches
    (SGD, SIM_TOL): the message log audited every round, its bytes the
    preset's price, the GCNII launches a round (M a layer in the joint
    inference, one in each local step), rounds/s of both and a profiled
    simulated round's idle share."""
    glasu, graph_agg = mods["glasu"], mods["graph_agg"]
    cfg = mods["get_preset"](BACKEND_PRESET)
    data = mods["make_vfl_dataset"](cfg.dataset, n_clients=cfg.n_clients,
                                    seed=cfg.seed)
    mcfg = cfg.glasu_config(data)
    sampler = mods["GlasuSampler"](data, cfg.sampler_config(),
                                   seed=cfg.seed + 11)
    host = mods["sample_rounds"](sampler, SIM_ROUNDS)
    p0 = glasu.init_params(torch.Generator().manual_seed(SEED + 5), mcfg,
                           "cpu")
    # warm-up, outside the counted run: both backends once
    for name in ("simulation", "vmapped"):
        _sgd_rounds(torch, mods, mods["make_backend"](name), mcfg, sampler,
                    p0, mods["unstack_round"](host, slice(0, 1)), cfg.lr)
    _zero_counts(graph_agg)                          # ---- counted run
    sim = _sgd_rounds(torch, mods, mods["make_backend"]("simulation"), mcfg,
                      sampler, p0, host, cfg.lr)
    counts = _counts(graph_agg)                      # ---- read counts
    vm = _sgd_rounds(torch, mods, mods["make_backend"]("vmapped"), mcfg,
                     sampler, p0, host, cfg.lr)
    # host time in turns (simulation, vmapped, vmapped, simulation)
    sim_s, vm_s = _turns(torch, mods, "simulation", sim, vm, mcfg, sampler,
                         p0, host, cfg.lr)
    launches = counts.pop("gcnii_layer_cuda")
    per_round = launches / SIM_ROUNDS
    want = (mcfg.n_clients + mcfg.n_local_steps) * mcfg.n_layers
    if per_round != want or any(counts.values()):
        raise AssertionError(f"simulation: {per_round} gcnii_layer_cuda "
                             f"launches a round (want {want}), the others "
                             f"{counts}")
    price = TRAIN_COMM_BYTES // 200
    if set(sim[2]) != {price} or set(vm[2]) != {price}:
        raise AssertionError(f"simulation bytes {sim[2]}, vmapped {vm[2]}, "
                             f"the preset's price {price}")
    if [log.total_bytes() for log in sim[5]] != list(sim[2]):
        raise AssertionError("the message logs do not carry the audited "
                             "bytes")
    leaves = [mods["tree_leaves"](r[0]) for r in (sim, vm)]
    torch.testing.assert_close(sim[1], vm[1], **SIM_TOL)
    for a, b in zip(*leaves):
        torch.testing.assert_close(a, b, **SIM_TOL)
    opt = mods["make_optimizer"]("sgd", cfg.lr)
    sb = mods["make_backend"]("simulation")
    sb.bind(mcfg, opt, sampler)
    batch = mods["batch_to_device"](mods["unstack_round"](host, 0), "cuda")
    p = mods["tree_map"](lambda t: t.to("cuda"), p0)
    wall, busy, idle = _profiled_round(
        torch, lambda: sb.run_round(p, opt.init(p), batch))
    n_msgs = len(sim[5][0].messages)
    print(f"sim: {BACKEND_PRESET} at full width (M {mcfg.n_clients}, L "
          f"{mcfg.n_layers}, hidden {mcfg.hidden}, Q {mcfg.n_local_steps}, "
          f"layer sizes {sampler.layer_sizes}), {SIM_ROUNDS} SGD rounds: "
          f"audited {sim[2][0]} B a round ({n_msgs} messages, == the "
          f"vmapped meter); gcnii_layer_cuda {per_round:.0f} launches a "
          f"round (vmapped: {mcfg.n_layers * (1 + mcfg.n_local_steps)}); "
          f"vs vmapped losses max abs {_max_diff(torch, [sim[1]], [vm[1]]):.3e},"
          f" params {_max_diff(torch, *leaves):.3e} (rtol "
          f"{SIM_TOL['rtol']:.0e}, atol {SIM_TOL['atol']:.0e}); "
          f"{SIM_ROUNDS / sim_s:.2f} rounds/s against vmapped "
          f"{SIM_ROUNDS / vm_s:.2f} (host clock, means of two {SIM_ROUNDS}-"
          f"round runs each, in turns); a profiled "
          f"round: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{idle:.3f}")
    return dict(bytes=sim[2][0], launches_per_round=per_round,
                rounds_per_s=SIM_ROUNDS / sim_s,
                vmapped_rounds_per_s=SIM_ROUNDS / vm_s, idle_share=idle)


def phase_sharded(torch, np, mods):
    """BACKEND_PRESET on a one-rank NCCL ShardedBackend: 200 Trainer rounds
    (the train phase's accuracy and bytes), the recorded collectives
    against the message log, SIM_ROUNDS SGD rounds against the vmapped
    engine (SHARD_TOL), and a sharded 16-query answer cold and warm against
    the vmapped session's (equal bills, the record_log replay)."""
    import torch.distributed as dist
    glasu, graph_agg = mods["glasu"], mods["graph_agg"]
    cfg = mods["get_preset"](BACKEND_PRESET).with_(backend="sharded")
    if TRAIN_ROUNDS is not None:
        cfg = cfg.with_(rounds=TRAIN_ROUNDS)
    data = mods["make_vfl_dataset"](cfg.dataset, n_clients=cfg.n_clients,
                                    seed=cfg.seed)
    warm = mods["Trainer"](cfg.with_(rounds=1, eval_every=1), data=data)
    warm.run()
    warm.close()
    _zero_counts(graph_agg)                          # ---- counted run
    trainer = mods["Trainer"](cfg, data=data)
    t0 = time.perf_counter()
    res = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(graph_agg)                      # ---- read counts
    launches = counts.pop("gcnii_layer_cuda")
    be, mcfg = trainer.backend, trainer.model_cfg
    mesh = be.mesh
    where = (f"{mesh.size} rank ({dist.get_backend(mesh.group)}), m_loc "
             f"{mesh.m_loc}, on {mesh.device}")
    if (mesh.size, mesh.m_loc) != (1, mcfg.n_clients) or \
            mesh.device.type != "cuda":
        raise AssertionError(f"the card's client mesh is {where}")
    if res.comm_bytes != TRAIN_COMM_BYTES or res.rounds_run != cfg.rounds:
        raise AssertionError(f"sharded: {res.comm_bytes} B in "
                             f"{res.rounds_run} rounds")
    if res.test_acc < TRAIN_PRESETS[BACKEND_PRESET][1]:
        raise AssertionError(f"sharded test accuracy {res.test_acc:.4f}")
    if launches < 20 * cfg.rounds or any(counts.values()):
        raise AssertionError(f"sharded: gcnii_layer_cuda {launches}, the "
                             f"others {counts}")
    shell = trainer.sampler.shape_shell_batch()
    log = mods["MessageLog"]()
    mods["log_agg_traffic"](log, shell, mcfg)
    star = sum(r.star_bytes() for r in be.collectives)
    if star != log.total_bytes():
        raise AssertionError(f"collectives {star} B, the log "
                             f"{log.total_bytes()} B")
    print(f"sharded: {BACKEND_PRESET} on a client mesh of {where}: "
          f"{res.rounds_run} Trainer rounds in {wall:.3f} s "
          f"({res.rounds_run / wall:.2f} rounds/s, host clock, "
          f"{len(res.history)} exact evals included), test acc "
          f"{res.test_acc:.4f} (>= {TRAIN_PRESETS[BACKEND_PRESET][1]}), val "
          f"acc {res.val_acc:.4f}, comm {res.comm_bytes} B (audited "
          f"{be.bytes_per_round} B a round); gcnii_layer_cuda launches "
          f"{launches}, the others {counts}")
    print(f"sharded: collectives of one round "
          f"{[(r.layer, r.n_rows, r.up_bytes, r.down_bytes) for r in be.collectives]}"
          f" (layer, rows, upload B, broadcast B): {star} B == "
          f"log_agg_traffic's uploads + broadcasts; + index sync "
          f"{be.bytes_per_round - star} B")
    stages = _round_breakdown(torch, mods, trainer,
                              graph_agg.gcnii_layer_cuda)
    trainer.close()

    sampler = mods["GlasuSampler"](data, cfg.sampler_config(),
                                   seed=cfg.seed + 13)
    host = mods["sample_rounds"](sampler, SIM_ROUNDS)
    p0 = glasu.init_params(torch.Generator().manual_seed(SEED + 6), mcfg,
                           "cpu")
    sh = _sgd_rounds(torch, mods, mods["make_backend"](
        "sharded", device="cuda"), mcfg, sampler, p0, host, cfg.lr)
    vm = _sgd_rounds(torch, mods, mods["make_backend"]("vmapped"), mcfg,
                     sampler, p0, host, cfg.lr)
    leaves = [mods["tree_leaves"](r[0]) for r in (sh, vm)]
    torch.testing.assert_close(sh[1], vm[1], **SHARD_TOL)
    for a, b in zip(*leaves):
        torch.testing.assert_close(a, b, **SHARD_TOL)
    if sh[2] != vm[2]:
        raise AssertionError(f"sharded bytes {sh[2]}, vmapped {vm[2]}")
    diff = _max_diff(torch, *leaves)
    sh_s, vm_s = _turns(torch, mods, "sharded", sh, vm, mcfg, sampler, p0,
                        host, cfg.lr)
    print(f"sharded: {SIM_ROUNDS} SGD rounds vs vmapped from the same params "
          f"and batches: losses max abs "
          f"{_max_diff(torch, [sh[1]], [vm[1]]):.3e}, params {diff:.3e}"
          f"{' (bitwise)' if diff == 0.0 else ''} (rtol=atol="
          f"{SHARD_TOL['atol']:.0e}); {sh[3] // SIM_ROUNDS} gcnii_layer_cuda "
          f"launches a round, as vmapped's {vm[3] // SIM_ROUNDS}; "
          f"{SIM_ROUNDS / sh_s:.2f} rounds/s against vmapped "
          f"{SIM_ROUNDS / vm_s:.2f} (host clock, means of two runs each, in "
          f"turns)")

    params = glasu.init_params(torch.Generator().manual_seed(SEED), mcfg,
                               "cpu")
    q = np.random.default_rng(SEED).choice(data.n_nodes, size=16,
                                           replace=False)
    answers = {}
    for engine in ("sharded", "vmapped"):
        sess = mods["InferenceSession"](
            params, cfg, data, serve=mods["ServeConfig"](
                max_batch=16, engine=engine, record_log=True))
        if engine == "sharded":
            sess.answer(q)                           # warm-up
            sess.cache.clear()
            _zero_counts(graph_agg)                  # ---- counted run
        answers[engine] = (sess.answer(q), sess.answer(q))
        if engine == "sharded":
            serve_launches = _counts(graph_agg)      # ---- read counts
        sess.close()
    (cold, warm), (vcold, vwarm) = answers["sharded"], answers["vmapped"]
    n_serve = serve_launches.pop("gcnii_layer_cuda")
    if n_serve < mcfg.n_layers or any(serve_launches.values()):
        raise AssertionError(f"sharded serving: gcnii_layer_cuda {n_serve}, "
                             f"the others {serve_launches}")
    bill = lambda a: (a.upload_bytes, a.broadcast_bytes, a.index_bytes)
    if bill(cold) != bill(vcold) or cold.log.total_bytes() != \
            cold.wire_bytes or warm.wire_bytes != 0 or not cold.cold:
        raise AssertionError(f"sharded bills {bill(cold)} / {bill(warm)}, "
                             f"vmapped {bill(vcold)}")
    if not np.array_equal(cold.logits, warm.logits):
        raise AssertionError("the sharded warm answer is not bitwise cold")
    np.testing.assert_allclose(cold.per_client, vcold.per_client,
                               **SHARD_TOL)
    print(f"sharded: 16-query answer on the sharded engine: cold {bill(cold)}"
          f" B (upload, broadcast, index) == the vmapped engine's and the "
          f"record_log replay's {cold.log.total_bytes()} B, warm 0 B and "
          f"bitwise cold; per-client logits vs vmapped max abs "
          f"{np.abs(cold.per_client - vcold.per_client).max():.3e}; cold "
          f"{cold.latency_s * 1e3:.3f} ms, warm {warm.latency_s * 1e3:.3f} "
          f"ms; gcnii_layer_cuda launches {n_serve} (cold, warm)")
    return dict(rounds_per_s=res.rounds_run / wall, test_acc=res.test_acc,
                launches=launches, serve_launches=n_serve,
                turns_rounds_per_s=SIM_ROUNDS / sh_s,
                turns_vmapped_rounds_per_s=SIM_ROUNDS / vm_s, **stages)


def _audit_meters(torch, mods, cfg, data):
    """benchmarks/comm_compression.py:69 ``_audit_meters`` on the port:
    bind the sharded backend (its bind audits the collectives against the
    message log) and replay one simulated round; the two meters agree.
    Returns the audited bytes a round."""
    mcfg = cfg.glasu_config(data)
    sampler = mods["GlasuSampler"](data, cfg.sampler_config(), seed=cfg.seed)
    opt = cfg.make_optimizer()
    sb = mods["make_backend"]("sharded", device="cuda")
    sb.bind(mcfg, opt, sampler)          # raises if the meters disagree
    mb = mods["make_backend"]("simulation")
    mb.bind(mcfg, opt, sampler)
    params = mods["glasu"].init_params(torch.Generator().manual_seed(
        cfg.seed), mcfg)
    batch = mods["batch_to_device"](sampler.sample_round(), "cuda")
    out = mb.run_round(params, opt.init(params), batch)
    up_down = out.message_log.total_bytes("upload") \
        + out.message_log.total_bytes("broadcast")
    if sum(r.star_bytes() for r in sb.collectives) != up_down:
        raise AssertionError("collective records diverge from the simulated "
                             "round's payloads")
    if sb.bytes_per_round != out.comm_bytes:
        raise AssertionError("sharded and simulation byte meters diverge")
    sb.close()
    return sb.bytes_per_round


def _audit_fault_meters(torch, mods, cfg, data, rounds=FAULT_AUDIT_ROUNDS):
    """benchmarks/fault_bench.py:71 ``_audit_fault_meters`` on the port:
    ``rounds`` simulated fault rounds, each log's delivered and sent bytes
    against the analytic model term by term. Returns (delivered bytes,
    uploads delivered, uploads attempted)."""
    mcfg = cfg.glasu_config(data)
    sampler = mods["GlasuSampler"](data, cfg.sampler_config(), seed=cfg.seed)
    opt = cfg.make_optimizer()
    mb = mods["make_backend"]("simulation")
    mb.bind(mcfg, opt, sampler)          # run_round re-audits every round
    sched = mods["FaultSchedule"](cfg.faults, mcfg.n_clients)
    params = mods["glasu"].init_params(torch.Generator().manual_seed(
        cfg.seed), mcfg)
    opt_state = opt.init(params)
    index_sync = sum(2 * mcfg.n_clients * sampler.layer_sizes[j] * 4
                     for j in range(mcfg.n_layers + 1) if sampler._shared(j))
    comp = mods["make_compressor"](cfg.compression)
    per_layer = [(sampler.layer_sizes[l + 1] * mcfg.hidden * 4,) * 2
                 if comp is None else
                 (comp.wire_bytes(sampler.layer_sizes[l + 1], mcfg.hidden),) * 2
                 for l in sorted(mcfg.agg_layers)]
    delivered = n_present = n_attempted = 0
    for _ in range(rounds):
        plan = sched.next_round()
        batch = mods["batch_to_device"](sampler.sample_round(), "cuda")
        out = mb.run_round(params, opt_state, batch, faults=plan)
        params, opt_state = out.params, out.opt_state
        n_att = int(plan.attempted.sum())
        want = index_sync + sum(plan.n_present * up + mcfg.n_clients * down
                                for up, down in per_layer)
        sent = index_sync + sum(n_att * up + mcfg.n_clients * down
                                for up, down in per_layer)
        if out.message_log.total_bytes() != want:
            raise AssertionError(f"delivered meter "
                                 f"{out.message_log.total_bytes()} != "
                                 f"analytic {want}")
        if out.message_log.total_bytes(delivered_only=False) != sent:
            raise AssertionError("sent-traffic meter disagrees with the "
                                 "attempted uploads")
        delivered += want
        n_present += plan.n_present
        n_attempted += n_att
    return delivered, n_present, n_attempted


def phase_powerlaw(torch, np, mods):
    """Builds powerlaw-1m into a temporary directory, trains
    powerlaw1m-gcn-glasu for its 50 rounds on the card and serves the
    trained parameters from the streamed store."""
    import shutil
    import tempfile
    cfg = mods["get_preset"](POWERLAW_PRESET)
    root = tempfile.mkdtemp(prefix="chip_smoke_powerlaw_")
    try:
        t0 = time.perf_counter()
        data = mods["make_powerlaw_dataset"](cfg.dataset,
                                             n_clients=cfg.n_clients,
                                             seed=cfg.seed, root=root)
        build_s = time.perf_counter() - t0
        feat_dims = [c.feat_dim for c in data.clients]
        print(f"powerlaw: {cfg.dataset} built in {build_s:.3f} s: "
              f"N={data.n_nodes} edges {len(data.full.indices)} (directed), "
              f"feature file {data.full.features.nbytes_disk} B in a "
              f"temporary directory, client feature blocks {feat_dims}, "
              f"classes {data.n_classes}")
        if (data.n_nodes, data.n_clients, data.n_classes, feat_dims) != \
                (POWERLAW_NODES, 2, 16, [32, 32]):
            raise AssertionError(f"{cfg.dataset} is not at its published "
                                 "size")
        params = _powerlaw_train(torch, mods, cfg, data)
        return _powerlaw_serve(torch, np, mods, cfg, data, params)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _powerlaw_train(torch, mods, cfg, data):
    graph_agg = mods["graph_agg"]
    rows = []

    class LossLog(mods["Hook"]):
        """Every round's losses (device rows, read after the run)."""

        def on_round_end(self, trainer, metrics):
            rows.append(metrics["losses"])

    _zero_counts(graph_agg)                              # ---- counted run
    trainer = mods["Trainer"](cfg, data=data, hooks=[LossLog()])
    t0 = time.perf_counter()
    res = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(graph_agg)                          # ---- read counts
    mcfg = trainer.model_cfg
    losses = torch.stack(rows).cpu()
    hooks = [type(h).__name__ for h in trainer.hooks]
    print(f"powerlaw: {cfg.name} M={mcfg.n_clients} L={mcfg.n_layers} "
          f"hidden={mcfg.hidden} d_in={mcfg.d_in} classes={mcfg.n_classes} "
          f"Q={mcfg.n_local_steps} {cfg.optimizer} lr={cfg.lr} layer sizes "
          f"{trainer.sampler.layer_sizes}: {res.rounds_run} rounds in "
          f"{wall:.3f} s ({res.rounds_run / wall:.2f} rounds/s on the host "
          f"clock, no exact eval); losses round 1 "
          f"{[round(float(x), 4) for x in losses[0]]}, round "
          f"{res.rounds_run} {[round(float(x), 4) for x in losses[-1]]}; "
          f"comm {res.comm_bytes} B; launches {counts}; hooks {hooks}")
    if res.rounds_run != cfg.rounds or len(rows) != cfg.rounds:
        raise AssertionError(f"{cfg.name} ran {res.rounds_run} rounds")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{cfg.name}: a non-finite loss")
    if res.comm_bytes != POWERLAW_COMM_BYTES:
        raise AssertionError(f"{cfg.name} metered {res.comm_bytes} B, "
                             f"expected {POWERLAW_COMM_BYTES}")
    want = cfg.rounds * (1 + mcfg.n_local_steps) * mcfg.n_layers
    if counts.pop("graph_agg_cuda") != want or any(counts.values()):
        raise AssertionError(f"{cfg.name}: expected {want} graph_agg_cuda "
                             f"launches and no other kernel, got {counts}")
    if hooks != ["CommMeterHook", "LossLog"]:
        raise AssertionError(f"{cfg.name}: unexpected hooks {hooks}")
    return res.params


def _powerlaw_serve(torch, np, mods, cfg, data, params):
    graph_agg, ops = mods["graph_agg"], mods["ops"]
    serve = mods["ServeConfig"](max_batch=16)
    q = np.asarray(POWERLAW_QUERY)

    def session(device):
        t = time.perf_counter()
        sess = mods["InferenceSession"](params, cfg, data, serve=serve,
                                        device=device)
        return sess, time.perf_counter() - t

    # warm-up session, outside the counted run: CUDA context, library
    # handles, and the CSR kernel's main-path inputs for the result line
    with _Capture(ops, "graph_agg_csr_cuda") as cap:
        warm_sess, _ = session("cuda")
        warm_sess.answer(q)
    captured = cap.calls
    del warm_sess

    sess, sess_s = session("cuda")
    sizes = sess._plan_sizes(16)
    _zero_counts(graph_agg)                              # ---- counted run
    cold = sess.answer(q)
    per_cold = _counts(graph_agg)
    warm = sess.answer(q)
    one = sess.answer([7])
    counts = _counts(graph_agg)                          # ---- read counts
    torch.cuda.synchronize()
    launches = counts["graph_agg_csr_cuda"]
    print(f"powerlaw: serving {cfg.name} (session built in {sess_s:.3f} s, "
          f"neighbor tables only, W={sess.W}); 16-query plan sizes {sizes}, "
          f"1-query {sess._plan_sizes(1)}; cold answer launches {per_cold}; "
          f"counted run (cold, warm, 1-query cold) {counts}")
    if sizes != [67600, 1040, 16] or not sess._streamed:
        raise AssertionError(f"unexpected serving plan {sizes}")
    if per_cold != {"graph_agg_cuda": 1, "gcnii_layer_cuda": 0,
                    "gat_layer_cuda": 0, "graph_agg_csr_cuda": 1,
                    "flash_attention_cuda": 0}:
        raise AssertionError(f"a cold 16-query answer launched {per_cold}")
    if counts["graph_agg_csr_cuda"] != 1 or counts["graph_agg_cuda"] != 3:
        raise AssertionError("the warm or the 1-query answer launched the "
                             f"CSR kernel, or the GCN kernel wrongly: {counts}")
    if cold.wire_bytes != POWERLAW_WIRE_BYTES or not cold.cold:
        raise AssertionError(f"cold answer billed {cold.wire_bytes} B, "
                             f"expected {POWERLAW_WIRE_BYTES}")
    if warm.cold or warm.wire_bytes != 0 or \
            not np.array_equal(warm.logits, cold.logits):
        raise AssertionError("the repeated query did not take the warm path")
    if not one.cold or cold.logits.shape != (16, data.n_classes) or \
            not np.isfinite(cold.logits).all():
        raise AssertionError(f"bad logits {cold.logits.shape}")

    cpu, cpu_s = session("cpu")
    want = cpu.answer(q)
    np.testing.assert_allclose(cold.logits, want.logits, **SLICE_TOL)
    np.testing.assert_allclose(cold.per_client, want.per_client, **SLICE_TOL)
    if (want.fresh_rows, want.wire_bytes) != (cold.fresh_rows,
                                              cold.wire_bytes):
        raise AssertionError("CPU and CUDA sessions billed different bytes")
    print(f"powerlaw: cold wire {cold.wire_bytes} B (fresh rows "
          f"{cold.fresh_rows}), warm {warm.wire_bytes} B; CUDA vs CPU (plain "
          f"CSR and GCN versions) cold logits max abs diff "
          f"{np.abs(cold.logits - want.logits).max():.3e} (rtol=atol="
          f"{SLICE_TOL['atol']:.0e}); CPU answer "
          f"{want.latency_s * 1e3:.3f} ms")

    cold_ms, warm_ms = [], []
    for _ in range(10):
        sess.cache.clear()
        cold_ms.append(sess.answer(q).latency_s * 1e3)
    for _ in range(100):
        warm_ms.append(sess.answer(q).latency_s * 1e3)
    print(f"slice: {cfg.name} 16-query answer latency cold median "
          f"{statistics.median(cold_ms):.3f} ms "
          f"({1e3 / statistics.mean(cold_ms):.1f} answers/s), warm median "
          f"{statistics.median(warm_ms):.3f} ms "
          f"({1e3 / statistics.mean(warm_ms):.1f} answers/s)")
    _cold_breakdown(torch, np, sess, q, mods["glasu"], cfg.name)
    return launches, captured


# ------------------------------------------------------------ transformer
def smollm_config(**kw):
    """SmolLM-360M (HuggingFaceTB/SmolLM-360M) at its published widths, as
    the reference's own history recorded them (``git show
    45395fd:src/repro/configs/smollm_360m.py``): 32 layers, d_model 960, 15
    heads over 5 kv heads of 64, d_ff 2560, vocab 49152, bf16. The repo
    registers only its reduced variant (``get_reduced("smollm_360m")``)."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**{**dict(
        name="smollm-360m", kind="dense", n_layers=32, d_model=960,
        n_heads=15, n_kv=5, d_head=64, d_ff=2560, vocab=49152,
        dtype="bfloat16", optimizer="adamw", lr=3e-4, use_flash=True), **kw})


def _visible_pairs(s, t, causal, window):
    """(query, key) pairs the mask lets through, per (batch, head)."""
    pairs = 0
    for i in range(s):
        hi = min(i, t - 1) if causal else t - 1
        lo = max(i - window + 1, 0) if window is not None else 0
        pairs += max(hi - lo + 1, 0)
    return pairs


def _flash_bound(b, s, t, h, kv, dh, causal, window, dtype):
    """(bound_ms, bound_by, bytes, flops) of one attention call: q, k, v
    read once and the output written once; 4·dh flops a visible (query,
    key) pair and head (q·k and p·v), over the card's peak for the inputs'
    type: bf16 on the tensor cores, fp32 outside them."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * s * h * dh + 2 * b * t * kv * dh) * item
    flops = 4 * b * h * dh * _visible_pairs(s, t, causal, window)
    peak = BF16_FLOP_PER_S if dtype == "bfloat16" else FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def _flash_bf16_excess(got, want):
    """max(|got - want| - FLASH_BF16_RTOL * |want|): at most FLASH_BF16_ATOL
    when the two differ by no more than one bf16 rounding."""
    want = want.float()
    return float(((got.float() - want).abs()
                  - FLASH_BF16_RTOL * want.abs()).max())


def _check_flash_bf16(what, got, want):
    """Every bf16 flash check: one bf16 rounding; -> (max abs err,
    excess)."""
    err = float((got.float() - want.float()).abs().max())
    excess = _flash_bf16_excess(got, want)
    if excess > FLASH_BF16_ATOL or not bool(got.float().isfinite().all()):
        raise AssertionError(
            f"{what}: |kernel - plain| exceeds 2^-7 |plain| by {excess:.3e} "
            f"(> {FLASH_BF16_ATOL:.0e}; max abs err {err:.3e})")
    return err, excess


def _flash_args(torch, gen, b, s, t, h, kv, dh, dtype):
    dt = getattr(torch, dtype)
    return [torch.randn(shape, generator=gen, device="cuda").to(dt)
            for shape in ((b, s, h, dh), (b, t, kv, dh), (b, t, kv, dh))]


def _flash_packed_args(torch, gen, b, s, t, h, kv, dh, dtype):
    """q, k, v as slices of one packed (B, S, H + 2 Kv, dh) tensor (S = T):
    strided views, as a fused qkv projection gives them."""
    packed = torch.randn((b, s, h + 2 * kv, dh), generator=gen,
                         device="cuda").to(getattr(torch, dtype))
    return [packed[:, :, :h], packed[:, :, h:h + kv], packed[:, :, h + kv:]]


def _sdpa_library(torch, q, k, v, causal):
    """One PyTorch call computing the same function (the yardstick; the
    port never calls it): scaled_dot_product_attention on (B, H, S, dh)
    views, native GQA."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True).transpose(1, 2)


# the reference's shape at which the fp32 (CUDA-core) kernel's time goes to
# the kernels line: tests/test_kernels.py's "gqa 4:1 multi-block"
FLASH_F32_TIMED = ((2, 256, 256, 8, 2, 64), True, None)


def phase_kernels_flash(torch, flash):
    """Flash kernel vs its plain version on the card: the reference's four
    test shapes causal and not, windows 32 / 128 / 511, dh 80 and 128, and
    dh 40 / 96, S and T that are multiples of no tile, packed qkv slices,
    each in fp32 (2e-5) and bf16 (one bf16 rounding); the constant-v
    property in both dtypes; the main-path shape. -> the fp32 kernel's
    numbers at FLASH_F32_TIMED and the worst bf16 excess."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    shapes = [((1, 128, 128, 4, 4, 32), c, None) for c in (True, False)] \
        + [((2, 256, 256, 8, 2, 64), c, None) for c in (True, False)] \
        + [((1, 200, 200, 4, 1, 64), c, None) for c in (True, False)] \
        + [((2, 96, 320, 4, 2, 32), c, None) for c in (True, False)] \
        + [((1, 512, 512, 2, 2, 32), True, w) for w in (32, 128, 511)] \
        + [((2, 200, 200, 3, 1, 80), True, None),
           ((1, 130, 130, 4, 2, 128), True, None),
           ((1, 150, 150, 4, 2, 40), True, None),
           ((1, 140, 140, 2, 1, 96), False, None),
           ((1, 201, 333, 4, 2, 64), True, None),
           ((1, 201, 333, 4, 2, 64), False, None)]
    cases = [(shape, causal, window, dtype, False)
             for shape, causal, window in shapes
             for dtype in ("float32", "bfloat16")]
    cases += [((2, 300, 300, 6, 2, 64), True, None, dtype, True)
              for dtype in ("float32", "bfloat16")]
    cases.append((MAIN_FLASH_SHAPE, True, None, "bfloat16", False))
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_excess = float("-inf")
    f32 = None
    for shape, causal, window, dtype, packed in cases:
        args = _flash_packed_args if packed else _flash_args
        q, k, v = args(torch, gen, *shape, dtype)
        got = flash.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window)
        torch.cuda.synchronize()
        want = flash.flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
        what = (f"flash_attention_cuda vs plain at {shape} causal={causal} "
                f"window={window} {dtype}{' packed' if packed else ''}")
        if got.dtype != q.dtype or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{what}: dtype {got.dtype} or non-finite "
                                 "values")
        err = float((got.float() - want.float()).abs().max())
        worst[dtype] = max(worst[dtype], err)
        tol = ""
        if dtype == "bfloat16":
            err, excess = _check_flash_bf16(what, got, want)
            worst_excess = max(worst_excess, excess)
            tol = f" (|err| - 2^-7 |plain| max {excess:.3e})"
        elif err > FLASH_F32_TOL:
            raise AssertionError(f"{what}: max abs err {err:.3e} > "
                                 f"{FLASH_F32_TOL:.0e}")
        main = shape == MAIN_FLASH_SHAPE
        reps = 10 if main else REPS
        k_ms = _time_ms(torch, lambda: flash.flash_attention_cuda(
            q, k, v, causal=causal, window=window), reps=reps)
        p_ms = _time_ms(torch, lambda: flash.flash_attention_plain(
            q, k, v, causal=causal, window=window), reps=reps)
        bound_ms, bound_by, nbytes, flops = _flash_bound(*shape, causal,
                                                         window, dtype)
        lib = ""
        if main:
            lib_ms = _time_ms(torch, lambda: _sdpa_library(torch, q, k, v,
                                                           causal))
            lib = (f" library_ms={lib_ms:.4f} (scaled_dot_product_attention)"
                   f" {flops / k_ms / 1e9:.1f} TFLOP/s")
        if (shape, causal, window) == FLASH_F32_TIMED and dtype == "float32":
            f32 = dict(shape=list(shape), causal=causal, window=window,
                       max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       tflops=flops / k_ms / 1e9)
        print(f"kernels: flash_attention B,S,T,H,Kv,dh={shape} "
              f"causal={causal} window={window} {dtype}"
              f"{' packed qkv slices' if packed else ''} max_abs_err="
              f"{err:.3e}{tol} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"bound_us={bound_ms * 1e3:.3f} ({bound_by}; {nbytes} B, "
              f"{flops} flop){lib}")
    for dtype in ("float32", "bfloat16"):
        q, k, v = _flash_args(torch, gen, 1, 257, 257, 4, 2, 32, dtype)
        v.fill_(3.25)
        for window in (None, 40):
            got = flash.flash_attention_cuda(q, k, v, causal=True,
                                             window=window)
            torch.cuda.synchronize()
            if float((got.float() - 3.25).abs().max()) > 1e-5:
                raise AssertionError("flash_attention_cuda: a constant v "
                                     "does not give a constant output "
                                     f"({dtype}, window {window})")
    print(f"kernels: flash_attention worst max_abs_err fp32 "
          f"{worst['float32']:.3e} <= {FLASH_F32_TOL:.0e}, bf16 "
          f"{worst['bfloat16']:.3e} with |err| - 2^-7 |plain| at most "
          f"{worst_excess:.3e} <= {FLASH_BF16_ATOL:.0e} on every bf16 case; "
          "constant v gives a constant output (fp32 and bf16, causal and "
          "window 40)")
    return dict(fp32=f32, bf16_worst_excess=worst_excess)


def phase_flash_32k(torch, flash):
    """One launch at the 32k serving shape (prefill_32k's sequence, B 1):
    error against the plain version, device time beside the bound and the
    library call."""
    b, s, h, kv, dh = FLASH_32K_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    q, k, v = _flash_args(torch, gen, b, s, s, h, kv, dh, "bfloat16")
    got = flash.flash_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = flash.flash_attention_plain(q, k, v, causal=True)
    err, excess = _check_flash_bf16("flash_attention_cuda at 32k", got, want)
    del want
    out = dict(
        max_abs_err=err, bf16_excess=excess,
        ms=_time_ms(torch, lambda: flash.flash_attention_cuda(q, k, v),
                    reps=5, warmup=1),
        plain_ms=_time_ms(torch, lambda: flash.flash_attention_plain(q, k, v),
                          reps=3, warmup=1),
        library_ms=_time_ms(torch, lambda: _sdpa_library(torch, q, k, v,
                                                         True), reps=5))
    bound_ms, bound_by, nbytes, flops = _flash_bound(b, s, s, h, kv, dh, True,
                                                     None, "bfloat16")
    out.update(bound_ms=bound_ms, bound_by=bound_by,
               tflops=flops / out["ms"] / 1e9,
               bound_share=bound_ms / out["ms"])
    print(f"flash32k: B={b} S=T={s} H={h} Kv={kv} dh={dh} bf16 causal: "
          f"max_abs_err={err:.3e} (|err| - 2^-7 |plain| max {excess:.3e}"
          f" <= {FLASH_BF16_ATOL:.0e}) kernel_ms={out['ms']:.4f} plain_ms="
          f"{out['plain_ms']:.4f} library_ms={out['library_ms']:.4f} "
          f"bound_us={bound_ms * 1e3:.3f} ({bound_by}; {nbytes} B, {flops} "
          f"flop); {out['tflops']:.1f} TFLOP/s, {out['bound_share']:.3f} of "
          "the bound")
    return out


@contextlib.contextmanager
def _swapped(obj, name, fn):
    orig = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _prefill_logits(tfm, params, cfg, toks):
    """Prefill the prompt, then the last position @ unemb: (B, vocab)."""
    hidden, _ = tfm.lm_forward(params, cfg, tokens=toks, return_hidden=True)
    return hidden[:, -1] @ params["unemb"]


def _host_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


ATTN_MARK = "spin_kernel"      # torch.cuda._sleep's kernel: a trace marker


def _attention_marked(torch, mods, calls):
    """Patches that bracket every plain attention call (``_sdpa`` and
    ``_sdpa_chunked``; outermost only) with a 1-cycle marker kernel
    (``torch.cuda._sleep``) on each side, so that ``_device_trace`` counts
    the kernels between two markers as the attention's: its forward, and
    under remat its recompute (the backward's kernels run outside the
    call). Each call appends to ``calls``. The flash kernel is counted by
    name."""
    attn = mods["attn"]
    depth = [0]

    def wrap(fn):
        def inner(*args, **kw):
            if depth[0]:
                return fn(*args, **kw)
            depth[0] += 1
            calls.append(1)
            torch.cuda._sleep(1)
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda._sleep(1)
                depth[0] -= 1
        return inner

    stack = contextlib.ExitStack()
    for obj, name in ((attn, "_sdpa"), (attn, "_sdpa_chunked")):
        stack.enter_context(_swapped(obj, name, wrap(getattr(obj, name))))
    return stack


def _device_trace(torch, fn, mods=None):
    """One call of ``fn`` under torch.profiler, device activity only (CPU op
    tracing would slow the host and inflate the idle share), read from the
    raw trace (``key_averages`` over a GLASU Q-step's ~68k kernels took
    most of a minute). Returns (fn's result, wall ms to sync under the
    profiler, {name: (device ns, count)} of the kernels and copies, and
    with ``mods`` (the plain-attention kernels' ns between
    ``_attention_marked``'s markers, the markers in the trace, the markers
    launched), else None). A trace that holds fewer markers than were
    launched has lost records (seen once over a GLASU Q-step's ~68k)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    calls = []
    with contextlib.ExitStack() as stack:
        if mods is not None:
            stack.enter_context(_attention_marked(torch, mods, calls))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out, wall_ms = _host_ms(torch, fn)
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA),
                    key=lambda e: e.start_ns())
    by_name, inside, attn_ns, marks = {}, False, 0, 0
    for e in events:
        if mods is not None and ATTN_MARK in e.name():
            inside, marks = not inside, marks + 1
            continue
        ns, n = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (ns + e.duration_ns(), n + 1)
        attn_ns += e.duration_ns() if inside else 0
    attn = (attn_ns, marks, 2 * len(calls)) if mods is not None else None
    return out, wall_ms, by_name, attn


def _print_top(prefix, by_name, n, width=80):
    for name, (ns, k) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:n]:
        print(f"{prefix}   device {ns / 1e3:10.1f} us x{k:<5d} "
              f"{name[:width]}")


def _device_profile(torch, fn, label, mods=None):
    """``fn`` once to sync on the host clock, then once under
    ``_device_trace``: wall (both), device busy (the kernels' and copies'
    summed time), idle share (1 - busy / the profiled wall; also against
    the unprofiled one), the GEMM kernels' time (the plain attention's
    batched products included), the top device ops; with ``mods``, also
    the attention: the flash kernel by name plus the plain attention's
    kernels, and whether the trace holds every marker (traced once more if
    not; an incomplete trace is printed as such, not failed: it is a
    measurement, and every check lies elsewhere)."""
    # the result is dropped at once: a second MoE train state does not fit
    plain_ms = _host_ms(torch, fn)[1]
    for attempt in (1, 2):       # once more if the trace lost records
        wall_ms, by_name, attn = _device_trace(torch, fn, mods)[1:]
        if attn is None or attn[1] == attn[2]:
            break
    busy = sum(ns for ns, _ in by_name.values()) / 1e6
    gemm_ms = sum(ns for name, (ns, _) in by_name.items()
                  if any(w in name.lower() for w in GEMM_WORDS)) / 1e6
    split = ""
    if attn is not None:
        plain_attn_ns, marks, want = attn
        flash_ms = sum(ns for name, (ns, _) in by_name.items()
                       if "flash_attention_kernel" in name) / 1e6
        attn_ms = flash_ms + plain_attn_ns / 1e6
        split = (f": attention {attn_ms:.3f} ms (flash kernel {flash_ms:.3f}"
                 f", plain attention's forward and recompute "
                 f"{plain_attn_ns / 1e6:.3f}), the rest {busy - attn_ms:.3f}"
                 f" ms; trace {'complete' if marks == want else 'INCOMPLETE'}"
                 f" ({marks} of {want} markers, attempt {attempt})")
    print(f"{label} profiled: wall {wall_ms:.3f} ms under the profiler, "
          f"{plain_ms:.3f} ms the call before without it; device busy "
          f"{busy:.3f} ms (idle share {1 - busy / wall_ms:.3f}, against the "
          f"unprofiled wall {1 - busy / plain_ms:.3f}; device-only trace)"
          f"{split}; GEMM kernels {gemm_ms:.3f} ms; "
          f"{sum(n for _, n in by_name.values())} device activities")
    _print_top(label, by_name, 6)


def phase_serve_lm(torch, mods, label, cfg, want_launches):
    """Serves ``cfg`` (SmolLM-360M widths, bf16, seed-0 weights) through
    ``make_serve_step``: a counted B x S prefill from TokenStream prompts
    (exactly ``want_launches`` flash launches and no other kernel), its
    median time and tokens/s, its last-position logits against the same
    prefill through the plain version on the card, then 32 greedy decode
    steps after the prompt's PREFILL_S positions, within DECODE_DEPTH-deep
    caches; then decode against prefill in
    fp32 (64-token prompt, B 2)."""
    tfm, flash, ops = mods["tfm"], mods["flash"], mods["ops"]
    graph_agg = mods["graph_agg"]
    init, step = mods["make_serve_step"](
        cfg, mods["InputShape"]("serve", DECODE_DEPTH, PREFILL_B, "decode"),
        device="cuda")
    (params, _), init_ms = _host_ms(
        torch, lambda: init(torch.Generator(device="cuda").manual_seed(SEED)))
    # the step decodes after the prompt: the caches hold PREFILL_S tokens, so
    # the DECODE_STEPS tokens go to slots PREFILL_S.. within DECODE_DEPTH
    # (make_serve_step's own caches are the reference's stand-in, marked as
    # holding DECODE_DEPTH - 1 tokens: one step would fill them). Their first
    # PREFILL_S slots are zeros, not the prompt's k and v: lm_forward, as in
    # the reference, returns no caches. Every slot up to pos is read all the
    # same; _decode_vs_prefill checks caches filled token by token
    caches = tfm.init_caches(cfg, PREFILL_B, DECODE_DEPTH,
                             prefill_len=PREFILL_S, device="cuda")
    n_params = sum(t.numel() for t in mods["tree_leaves"](params))
    toks, _ = mods["TokenStream"](cfg.vocab, seed=SEED).batch(PREFILL_B,
                                                              PREFILL_S)
    toks = toks.to("cuda")
    with torch.inference_mode():
        _zero_counts(graph_agg)                          # ---- counted run
        logits, cold_ms = _host_ms(
            torch, lambda: _prefill_logits(tfm, params, cfg, toks))
        counts = _counts(graph_agg)                      # ---- read counts
        launches = counts.pop("flash_attention_cuda")
        if launches != want_launches or any(counts.values()):
            raise AssertionError(f"{label} prefill: {launches} flash launches"
                                 f" (want {want_launches}), others {counts}")
        if logits.shape != (PREFILL_B, cfg.vocab) or \
                not torch.isfinite(logits.float()).all():
            raise AssertionError(f"{label}: bad prefill logits "
                                 f"{tuple(logits.shape)}")
        times = [_host_ms(torch, lambda: _prefill_logits(tfm, params, cfg,
                                                         toks))[1]
                 for _ in range(PREFILL_REPS)]
        med = statistics.median(times)
        plain = lambda q, k, v, **kw: flash.flash_attention_plain(q, k, v,
                                                                  **kw)
        with _swapped(ops, "flash_attention_cuda", plain):
            want = _prefill_logits(tfm, params, cfg, toks)
        err = float((logits.float() - want.float()).abs().max())
        agree = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
        if err > PREFILL_LOGIT_ATOL:
            raise AssertionError(f"{label}: prefill logits through the kernel"
                                 f" vs the plain version: max abs diff "
                                 f"{err:.3e} > {PREFILL_LOGIT_ATOL}")
        print(f"serve: {label} {cfg.n_layers} layers d_model {cfg.d_model} "
              f"heads {cfg.n_heads}/{cfg.n_kv} dh {cfg.d_head} d_ff "
              f"{cfg.d_ff} vocab {cfg.vocab} {cfg.dtype}, {n_params} "
              f"parameters (drawn on the card in {init_ms:.1f} ms); prefill "
              f"B={PREFILL_B} S={PREFILL_S}: {launches} flash launches, cold "
              f"{cold_ms:.3f} ms, median of {PREFILL_REPS} {med:.3f} ms "
              f"({PREFILL_B * PREFILL_S / med * 1e3:.0f} tokens/s); last-"
              f"position logits vs the plain version on the card: max abs "
              f"diff {err:.3e} (<= {PREFILL_LOGIT_ATOL}), argmax agreement "
              f"{agree:.3f}, |logit| max {float(logits.abs().max()):.3f}")
        out = dict(launches=launches)
        if label == "dense":
            with _Capture(ops, "flash_attention_cuda", limit=1) as cap:
                _prefill_logits(tfm, params, cfg, toks)
            out["captured"] = cap.calls
        _device_profile(torch,
                        lambda: _prefill_logits(tfm, params, cfg, toks),
                        f"serve: {label} prefill", mods)

        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        step_ms, gen_toks = [], []
        _zero_counts(graph_agg)
        for _ in range(DECODE_STEPS):
            (tok, caches), ms = _host_ms(torch, lambda: step(params, caches,
                                                             tok))
            step_ms.append(ms)
            gen_toks.append(tok)
        dcounts = _counts(graph_agg)
        pos = caches["kv" if cfg.glasu else "blocks"].pos
        gen = torch.cat(gen_toks, dim=1)
        if any(dcounts.values()) or not bool(
                (pos == PREFILL_S + DECODE_STEPS).all()) or \
                gen.shape != (PREFILL_B, DECODE_STEPS) or \
                not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
            raise AssertionError(f"{label} decode: launches {dcounts}, "
                                 f"positions {pos.tolist()}, tokens "
                                 f"{tuple(gen.shape)}")
        dmed = statistics.median(step_ms)
        print(f"serve: {label} decode {DECODE_STEPS} greedy steps, B="
              f"{PREFILL_B}, positions {PREFILL_S}.."
              f"{PREFILL_S + DECODE_STEPS - 1} of {DECODE_DEPTH}-deep caches:"
              " median "
              f"{dmed:.3f} ms a token step ({PREFILL_B / dmed * 1e3:.0f} "
              f"tokens/s), first {step_ms[0]:.3f} ms; no kernel launch (decode"
              f" attention is plain _sdpa, as in the reference)")
        _device_profile(torch, lambda: step(params, caches, tok),
                        f"serve: {label} decode step", mods)
    del params, caches
    torch.cuda.empty_cache()
    _decode_vs_prefill(torch, mods, label, cfg, want_launches)
    return out


def _decode_vs_prefill(torch, mods, label, cfg, want_launches):
    """fp32, the same widths: token-by-token lm_decode_step against the
    prefill argmax (tests/test_decode_consistency.py)."""
    tfm, flash = mods["tfm"], mods["flash"]
    cfg32 = cfg.with_(dtype="float32")
    params = tfm.init_lm(torch.Generator(device="cuda").manual_seed(SEED),
                         cfg32, "cuda")
    toks, _ = mods["TokenStream"](cfg.vocab, seed=SEED + 1).batch(CONSIST_B,
                                                                  CONSIST_S)
    toks = toks.to("cuda")
    with torch.inference_mode():
        before = flash.flash_attention_cuda.launches
        logits, _ = tfm.lm_forward(params, cfg32, tokens=toks)
        launches = flash.flash_attention_cuda.launches - before
        want = logits.argmax(-1)
        caches = tfm.init_caches(cfg32, CONSIST_B, CONSIST_S, device="cuda")
        got = []
        for i in range(CONSIST_S):
            nxt, caches = tfm.lm_decode_step(params, caches, cfg32,
                                             toks[:, i:i + 1])
            got.append(nxt)
        got = torch.cat(got, dim=1)
    agree = float((got == want).float().mean())
    last = bool((got[:, -1] == want[:, -1]).all())
    print(f"serve: {label} decode vs prefill (fp32, B={CONSIST_B}, "
          f"{CONSIST_S}-token prompt, {launches} flash launches in the "
          f"prefill): argmax agreement {agree:.3f} (>= 0.9), last position "
          f"{'equal' if last else 'DIFFERENT'}")
    if launches != want_launches or agree < 0.9 or not last:
        raise AssertionError(f"{label}: decode vs prefill agreement {agree}, "
                             f"last position equal {last}, {launches} flash "
                             "launches")
    del params, caches
    torch.cuda.empty_cache()


# ------------------------------------------------------ transformer training
# SmolLM-360M trained at its published widths: train_4k (B 256 x S 4096)
# cut to B 4 x S 2048, 10 steps on one fixed batch (loss must fall)
TRAIN_LM_B, TRAIN_LM_S, TRAIN_LM_STEPS = 4, 2048, 10
# the GLASU split: 3 calls of the Q = 4 step on that batch (12 microsteps)
GLASU_TRAIN_SPLIT, GLASU_TRAIN_CALLS = (5, 2, 4), 3
# phi3.5-moe at its published widths, depth cut to fit one card: 1 of 32
# layers trained (B 8 x S 1024, grad_accum 4: four microbatches of 2 x
# 1024), 2 served (a B 2 x S 2048 prefill, 16 greedy decode steps)
MOE_TRAIN_LAYERS, MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS = 1, 8, 1024, 4
MOE_SERVE_LAYERS, MOE_SERVE_B, MOE_SERVE_S, MOE_DECODE_STEPS = 2, 2, 2048, 16
# fp32 card vs CPU steps: reduced configs at the CPU tests' size
CARD_CPU_TRAIN = (("smollm_360m", {}, None),
                  ("phi35_moe_42b", dict(grad_accum=2), None),
                  ("smollm_360m", dict(d_ff=480), (3, 2, 3)))


def phi35_moe_config(**kw):
    """Phi-3.5-MoE (microsoft/Phi-3.5-MoE-instruct) at its published
    widths, as the reference's own history recorded them (``git show
    45395fd:src/repro/configs/phi35_moe_42b.py``): 32 layers, d_model 4096,
    32 heads over 8 kv heads of 128, 16 experts top-2 of d_ff 6400, vocab
    32064, grad_accum 4, bf16, adamw at 2e-4. The repo registers only its
    reduced variant."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**{**dict(
        name="phi3.5-moe-42b-a6.6b", kind="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv=8, d_head=128, d_ff=6400, vocab=32064, moe=True,
        n_experts=16, top_k=2, n_shared_experts=0, d_ff_expert=6400,
        grad_accum=4, dtype="bfloat16", optimizer="adamw", lr=2e-4), **kw})


def _gib(n):
    return f"{n / 2 ** 30:.2f} GiB"


def _lm_batch(torch, mods, vocab, b, s):
    toks, labels = mods["TokenStream"](vocab, seed=SEED).batch(b, s)
    return {"tokens": toks.to("cuda"), "labels": labels.to("cuda")}


def _no_launches(graph_agg, what):
    counts = _counts(graph_agg)
    if any(counts.values()):
        raise AssertionError(f"{what}: kernel launches {counts} (training "
                             "runs no hand-written kernel)")


def _train_run(torch, mods, cfg, batch, calls, label):
    """``calls`` train-step calls on one batch from seed-0 parameters,
    counted (no kernel may launch): (state, step, losses, metrics, host ms
    of each call, peak device memory)."""
    graph_agg = mods["graph_agg"]
    init, step = mods["make_train_step"](cfg, "cuda")
    torch.cuda.reset_peak_memory_stats()
    state = init(torch.Generator(device="cuda").manual_seed(SEED))
    losses, ms = [], []
    _zero_counts(graph_agg)                              # ---- counted run
    for _ in range(calls):
        (state, metrics), t = _host_ms(torch, lambda: step(state, batch))
        losses.append(float(metrics["loss"]))
        ms.append(t)
    _no_launches(graph_agg, label)                       # ---- read counts
    peak = torch.cuda.max_memory_allocated()
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: losses {losses}")
    return state, step, losses, metrics, ms, peak


def _steps_line(label, cfg, n_params, tokens, losses, ms, peak,
                prefix="train_lm"):
    """One line of a training run: widths, losses, cold and median host ms
    a train-step call, tokens/s, peak device memory."""
    med = statistics.median(ms[1:])
    print(f"{prefix}: {label} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"heads {cfg.n_heads}/{cfg.n_kv} dh {cfg.d_head} vocab {cfg.vocab} "
          f"{cfg.dtype} remat {cfg.remat} {cfg.optimizer}, {n_params} "
          f"parameters, {tokens} tokens a call: losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; call cold {ms[0]:.1f} ms, median of {len(ms) - 1} "
          f"{med:.1f} ms ({tokens / med * 1e3:.0f} tokens/s); peak device "
          f"memory {_gib(peak)}")


def phase_train_lm(torch, mods):
    """Trains SmolLM-360M dense and GLASU-split and phi3.5-moe (1 layer) at
    their published widths on the card, serves phi3.5-moe (2 layers)
    through the flash kernel, and holds fp32 train steps on the card to the
    CPU's."""
    tree_leaves = mods["tree_leaves"]
    out, part_s, t0 = {}, {}, time.perf_counter()

    def part(name):
        nonlocal t0
        part_s[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # ---- SmolLM-360M, dense
    cfg = smollm_config(use_flash=False)
    batch = _lm_batch(torch, mods, cfg.vocab, TRAIN_LM_B, TRAIN_LM_S)
    state, step, losses, _, ms, peak = _train_run(
        torch, mods, cfg, batch, TRAIN_LM_STEPS, "dense training")
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    _steps_line("dense", cfg, n_params, TRAIN_LM_B * TRAIN_LM_S, losses, ms,
                peak)
    if not losses[-1] < losses[0] or state.step != TRAIN_LM_STEPS:
        raise AssertionError(f"dense training: losses {losses}, step "
                             f"{state.step}")
    _device_profile(torch, lambda: step(state, batch),
                    "train_lm: dense step", mods)
    out["dense"] = dict(ms=statistics.median(ms[1:]), peak=peak)
    del state, step
    part("dense")

    # ---- the GLASU split of the same model, Q = 4
    split = cfg.with_(glasu=mods["GlasuSplit"](*GLASU_TRAIN_SPLIT))
    steps = mods["steps"]
    micro = []

    def timed(fn):
        def inner(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args)
            torch.cuda.synchronize()
            micro.append((time.perf_counter() - t0) * 1e3)
            return res
        return inner

    with _swapped(steps, "_value_and_grad", timed(steps._value_and_grad)):
        state, step, losses, _, ms, peak = _train_run(
            torch, mods, split, batch, GLASU_TRAIN_CALLS, "GLASU training")
    q = GLASU_TRAIN_SPLIT[2]
    joint = statistics.median(micro[q::q])
    stale = statistics.median([t for i, t in enumerate(micro[q:])
                               if i % q])
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    _steps_line(f"GLASU (M, sync_every, Q) = {GLASU_TRAIN_SPLIT}, Q "
                "microsteps a call,", split,
                n_params, TRAIN_LM_B * TRAIN_LM_S * q, losses, ms, peak)
    print(f"train_lm: GLASU forward + backward of a microstep (host clock "
          f"to sync, calls 2..{GLASU_TRAIN_CALLS}): joint {joint:.1f} ms, "
          f"stale {stale:.1f} ms (median); step counter {state.step}")
    if state.step != q * GLASU_TRAIN_CALLS or not losses[-1] < losses[0]:
        raise AssertionError(f"GLASU training: losses {losses}, step "
                             f"{state.step}")
    _device_profile(torch, lambda: step(state, batch),
                    "train_lm: GLASU Q-step", mods)
    out["glasu"] = dict(ms=statistics.median(ms[1:]), joint=joint,
                        stale=stale, peak=peak)
    del state, step, batch
    torch.cuda.empty_cache()
    part("GLASU")

    # ---- phi3.5-moe, 1 layer, trained
    moe = mods["moe"]
    moe_apply, dropped = moe.moe_apply, []

    def recording(*args, **kw):
        y, stats = moe_apply(*args, **kw)
        dropped.append(stats.dropped_frac.detach())
        return y, stats

    mcfg = phi35_moe_config(n_layers=MOE_TRAIN_LAYERS)
    batch = _lm_batch(torch, mods, mcfg.vocab, MOE_TRAIN_B, MOE_TRAIN_S)
    with _swapped(moe, "moe_apply", recording):
        state, step, losses, metrics, ms, peak = _train_run(
            torch, mods, mcfg, batch, MOE_TRAIN_STEPS, "MoE training")
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    _steps_line("phi3.5-moe", mcfg, n_params, MOE_TRAIN_B * MOE_TRAIN_S,
                losses, ms, peak)
    aux = float(metrics["aux"])
    # the last step's records (a recompute under remat may or may not get
    # as far as recording: the same value again, or none)
    drop = float(torch.stack(
        dropped[-(len(dropped) // MOE_TRAIN_STEPS):]).mean())
    print(f"train_lm: phi3.5-moe last step: aux {aux:.5f}, grad_norm "
          f"{float(metrics['grad_norm']):.4f}, dropped fraction of (token, "
          f"k) routes {drop:.4f} (mean over its {mcfg.grad_accum} "
          f"microbatches; capacity factor {mcfg.capacity_factor})")
    if not aux > 0 or not math.isfinite(aux):
        raise AssertionError(f"MoE training: aux {aux}")
    _device_profile(torch, lambda: step(state, batch),
                    "train_lm: phi3.5-moe step", mods)
    out["moe"] = dict(ms=statistics.median(ms[1:]), peak=peak, aux=aux,
                      dropped=drop)
    del state, step, batch, metrics
    torch.cuda.empty_cache()
    part("phi3.5-moe training")
    out["moe_serve"] = _moe_serve(torch, mods)
    part("phi3.5-moe serving")
    _train_card_vs_cpu(torch, mods)
    part("card vs CPU")
    print("train_lm: host seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in part_s.items()))
    return out


def _moe_serve(torch, mods):
    """phi3.5-moe (2 layers, bf16, seed-0 weights) through make_serve_step
    with the flash kernel: a counted B 2 x S 2048 prefill (exactly one flash
    launch a layer), its last-position logits against the plain version on
    the card, the first launch's output against the plain version at one
    bf16 rounding, then 16 greedy decode steps."""
    tfm, flash, ops = mods["tfm"], mods["flash"], mods["ops"]
    graph_agg = mods["graph_agg"]
    cfg = phi35_moe_config(n_layers=MOE_SERVE_LAYERS, use_flash=True)
    depth = MOE_SERVE_S + MOE_DECODE_STEPS
    _, step = mods["make_serve_step"](
        cfg, mods["InputShape"]("serve", depth, MOE_SERVE_B, "decode"),
        device="cuda")
    params = tfm.init_lm(torch.Generator(device="cuda").manual_seed(SEED),
                         cfg, "cuda")
    toks = _lm_batch(torch, mods, cfg.vocab, MOE_SERVE_B,
                     MOE_SERVE_S)["tokens"]
    with torch.inference_mode():
        _prefill_logits(tfm, params, cfg, toks)          # warm-up
        _zero_counts(graph_agg)                          # ---- counted run
        logits, ms = _host_ms(torch, lambda: _prefill_logits(tfm, params,
                                                             cfg, toks))
        counts = _counts(graph_agg)                      # ---- read counts
        launches = counts.pop("flash_attention_cuda")
        if launches != MOE_SERVE_LAYERS or any(counts.values()):
            raise AssertionError(f"phi3.5-moe prefill: {launches} flash "
                                 f"launches (want {MOE_SERVE_LAYERS}), others"
                                 f" {counts}")
        plain = lambda q, k, v, **kw: flash.flash_attention_plain(q, k, v,
                                                                  **kw)
        with _swapped(ops, "flash_attention_cuda", plain):
            want = _prefill_logits(tfm, params, cfg, toks)
        err = float((logits.float() - want.float()).abs().max())
        if err > PREFILL_LOGIT_ATOL or not bool(
                logits.float().isfinite().all()):
            raise AssertionError(f"phi3.5-moe prefill logits vs the plain "
                                 f"version: {err:.3e} > {PREFILL_LOGIT_ATOL}")
        with _Capture(ops, "flash_attention_cuda", limit=1) as cap:
            _prefill_logits(tfm, params, cfg, toks)
        launch = _flash_launch(torch, flash, cap.calls[0],
                               "phi3.5-moe flash launch")
        print(f"train_lm: phi3.5-moe serve {cfg.n_layers} layers, prefill "
              f"B={MOE_SERVE_B} S={MOE_SERVE_S}: {launches} flash launches, "
              f"{ms:.1f} ms; last-position logits vs the plain version on the "
              f"card {err:.3e} (<= {PREFILL_LOGIT_ATOL}); layer 0's launch "
              f"{_launch_text(launch)}")
        caches = tfm.init_caches(cfg, MOE_SERVE_B, depth,
                                 prefill_len=MOE_SERVE_S, device="cuda")
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        step_ms, gen = [], []
        _zero_counts(graph_agg)
        for _ in range(MOE_DECODE_STEPS):
            (tok, caches), t = _host_ms(torch, lambda: step(params, caches,
                                                            tok))
            step_ms.append(t)
            gen.append(tok)
        dcounts = _counts(graph_agg)
        gen = torch.cat(gen, dim=1)
        pos = caches["blocks"].pos
        if any(dcounts.values()) or not bool((pos == depth).all()) or \
                not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
            raise AssertionError(f"phi3.5-moe decode: launches {dcounts}, "
                                 f"positions {pos.tolist()}")
        print(f"train_lm: phi3.5-moe decode {MOE_DECODE_STEPS} greedy steps,"
              f" B={MOE_SERVE_B}, positions {MOE_SERVE_S}..{depth - 1}: "
              f"median {statistics.median(step_ms):.3f} ms a step, first "
              f"{step_ms[0]:.3f} ms")
    del params, caches
    torch.cuda.empty_cache()
    return dict(launches=launches, prefill_ms=ms, logit_err=err,
                launch=launch)


def _flash_launch(torch, flash, call, what):
    """One captured bf16 flash launch (args, kw) of a main path: the kernel
    against the plain version (one bf16 rounding), its device time beside
    the plain version's, SDPA's and the bound."""
    (q, k, v), kw = call
    got = flash.flash_attention_cuda(q, k, v, **kw)
    kerr, excess = _check_flash_bf16(
        what, got, flash.flash_attention_plain(q, k, v, **kw))
    b, s, h, dh = q.shape
    bound_ms, bound_by, _, _ = _flash_bound(
        b, s, k.shape[1], h, k.shape[2], dh, kw["causal"], kw["window"],
        "bfloat16")
    return dict(
        shape=f"B {b}, S = T = {s}, H {h}, Kv {k.shape[2]}, dh {dh}, bf16, "
              + ("causal" if kw["causal"] else "bidirectional"),
        max_abs_err=kerr, bf16_excess=excess,
        ms=_time_ms(torch, lambda: flash.flash_attention_cuda(q, k, v, **kw)),
        plain_ms=_time_ms(torch, lambda: flash.flash_attention_plain(
            q, k, v, **kw), reps=5),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=_time_ms(torch, lambda: _sdpa_library(
            torch, q, k, v, kw["causal"])))


def _launch_text(launch):
    return (f"({launch['shape']}) vs plain {launch['max_abs_err']:.3e} (one "
            f"bf16 rounding), {launch['ms']:.4f} ms (plain "
            f"{launch['plain_ms']:.4f}, SDPA {launch['library_ms']:.4f}, "
            f"bound {launch['bound_ms']:.4f} by {launch['bound_by']})")


def _train_card_vs_cpu(torch, mods, cases=CARD_CPU_TRAIN,
                       prefix="train_lm"):
    """One fp32 train step (momentum SGD, so the momentum buffer holds the
    step's clipped gradients) of reduced SmolLM, reduced phi3.5-moe
    (grad_accum 2) and the reduced SmolLM GLASU split (Q 3), from the same
    parameters and batch on the card and on the CPU: the loss and every
    gradient at GRAD_TOL."""
    tfm, base = mods["tfm"], mods["base"]
    for arch, over, split in cases:
        cfg = base.get_reduced(arch).with_(optimizer="sgd", **over)
        if split:
            cfg = cfg.with_(glasu=mods["GlasuSplit"](*split))
        params = tfm.init_lm(torch.Generator().manual_seed(SEED), cfg, "cpu")
        batch = mods["synth_train_batch"](
            cfg, mods["InputShape"]("t", 64, 2, "train"), seed=SEED)
        res = {}
        for dev in ("cpu", "cuda"):
            _, step = mods["make_train_step"](cfg, dev)
            opt = mods["steps"].make_optimizer(cfg)
            p = mods["tree_map"](lambda t: t.to(dev), params)
            state = mods["steps"].TrainState(p, opt.init(p), 0)
            res[dev] = step(state, {k: v.to(dev) for k, v in batch.items()})
        (cs, cm), (gs, gm) = res["cpu"], res["cuda"]
        loss_d = abs(float(gm["loss"]) - float(cm["loss"]))
        worst = 0.0
        for a, b in zip(mods["tree_leaves"](cs.opt_state.momentum),
                        mods["tree_leaves"](gs.opt_state.momentum)):
            b = b.cpu()
            if not torch.allclose(b, a, **GRAD_TOL):
                raise AssertionError(f"{cfg.name} card vs CPU gradients: "
                                     f"max abs diff "
                                     f"{float((a - b).abs().max()):.3e}")
            worst = max(worst, float((a - b).abs().max()))
        if not math.isclose(float(gm["loss"]), float(cm["loss"]),
                            rel_tol=GRAD_TOL["rtol"],
                            abs_tol=GRAD_TOL["atol"]) or gs.step != cs.step:
            raise AssertionError(f"{cfg.name} card vs CPU loss {loss_d:.3e}")
        print(f"{prefix}: {cfg.name}{' GLASU' if split else ''} fp32 train "
              f"step card vs CPU: loss {float(gm['loss']):.6f} (diff "
              f"{loss_d:.3e}), gradients (the momentum buffers after step "
              f"{gs.step}) max abs diff {worst:.3e} (rtol = atol = 1e-4)")


# ------------------------------------------------- the transformer families
# Each family at its published widths, as the reference's own history
# recorded them (git show 45395fd:src/repro/configs/<id>.py); the repo
# registers only their reduced variants. Served at full depth: a B 2 x S
# 2048 bf16 prefill (seamless: a 2048-frame source and 2048 target tokens;
# pixtral: 1024 patch embeddings and 1024 tokens), FAMILY_DECODE_STEPS greedy
# steps after it
FAMILY_B, FAMILY_S, FAMILY_DECODE_STEPS, FAMILY_PREFILL_REPS = 2, 2048, 16, 3
FAMILY_TRAIN_STEPS = 3


def deepseek_v2_lite_config(**kw):
    """DeepSeek-V2-Lite: 27 layers (layer 0 dense, d_ff 10944), d_model
    2048, MLA with 16 heads (kv_lora 512, d_nope 128, d_rope 64, d_v 128),
    64 experts top-6 + 2 shared of 1408, vocab 102400, grad_accum 2."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**{**dict(
        name="deepseek-v2-lite-16b", kind="moe", n_layers=27, d_model=2048,
        n_heads=16, n_kv=16, d_head=128, d_ff=10944, vocab=102400, moe=True,
        n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408,
        n_dense_layers=1, attn="mla", kv_lora=512, d_nope=128, d_rope=64,
        grad_accum=2, dtype="bfloat16", optimizer="adamw", lr=2e-4), **kw})


def zamba2_config(**kw):
    """Zamba2-1.2B: 38 Mamba2 layers (d_model 2048, d_state 64, 64 SSM heads
    of 64, ssm_chunk 256), one weight-shared attention + MLP block after
    every 6 (32 heads of 64, d_ff 8192), vocab 32000."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**{**dict(
        name="zamba2-1.2b", kind="hybrid", n_layers=38, d_model=2048,
        n_heads=32, n_kv=32, d_head=64, d_ff=8192, vocab=32000,
        block="mamba2", d_state=64, ssm_heads=64, ssm_head_dim=64,
        attn_every=6, dtype="bfloat16", optimizer="adamw", lr=3e-4), **kw})


def rwkv6_config(**kw):
    """RWKV-6 "Finch" 7B: 32 layers, d_model 4096 (64 heads of 64), channel
    mix d_ff 14336, vocab 65536, grad_accum 2."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**{**dict(
        name="rwkv6-7b", kind="ssm", n_layers=32, d_model=4096, n_heads=0,
        n_kv=0, d_head=0, d_ff=14336, vocab=65536, attn="none",
        block="rwkv6", ssm_heads=64, ssm_head_dim=64, grad_accum=2,
        dtype="bfloat16", optimizer="adamw", lr=3e-4), **kw})


def seamless_config(**kw):
    """SeamlessM4T-Large v2's backbone: 24 encoder + 24 decoder layers,
    d_model 1024, 16 heads of 64, d_ff 8192, vocab 256206; the audio
    frontend is a stub (source frame embeddings)."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**{**dict(
        name="seamless-m4t-large-v2", kind="audio", n_layers=24,
        enc_layers=24, dec_layers=24, d_model=1024, n_heads=16, n_kv=16,
        d_head=64, d_ff=8192, vocab=256206, frontend="audio",
        frontend_tokens=0, dtype="bfloat16", optimizer="adamw", lr=1e-4),
        **kw})


def pixtral_config(**kw):
    """Pixtral-12B's language backbone: 40 layers, d_model 5120, 32 / 8
    heads of 128, d_ff 14336, vocab 131072, rope theta 1e6, 1024 patch
    embeddings (the vision tower is a stub), grad_accum 4."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**{**dict(
        name="pixtral-12b", kind="vlm", n_layers=40, d_model=5120,
        n_heads=32, n_kv=8, d_head=128, d_ff=14336, vocab=131072,
        frontend="vision", frontend_tokens=1024, grad_accum=4,
        rope_theta=1e6, dtype="bfloat16", optimizer="adamw", lr=2e-4), **kw})


# label -> (published config, flash launches of a full-depth prefill: one
# per attention layer it runs; training: depth overrides, B, S). Training
# depths are cut to what AdamW's fp32 state leaves room for on one 80 GB
# card (the foreach AdamW peaks at ~42 bytes a parameter): deepseek keeps
# its dense head and 1 MoE layer (~1.07 B), rwkv6 2 layers (~0.94 B),
# seamless 4 + 4 (~0.78 B, its vocab 256206 dominates), pixtral 1 layer
# (~1.61 B, without gradient accumulation, whose summed-gradient tree would
# add two bf16 copies of them); zamba2 trains at full depth (~1.17 B)
FAMILIES = {
    "deepseek": (deepseek_v2_lite_config, 0, dict(n_layers=2), 4, 2048),
    "zamba2": (zamba2_config, 38 // 6, {}, 2, 2048),
    "rwkv6": (rwkv6_config, 0, dict(n_layers=2), 4, 2048),
    "seamless": (seamless_config, 48, dict(n_layers=4, enc_layers=4,
                                           dec_layers=4), 4, 2048),
    "pixtral": (pixtral_config, 40, dict(n_layers=1, grad_accum=1), 2,
                2048)}
# fp32 card vs CPU: each family's reduced config (zamba2 at 5 layers: two
# groups and a tail, as tests/test_torch_families.py runs it)
FAMILY_CARD_CPU = (("deepseek_v2_lite_16b", {}, None),
                   ("zamba2_1p2b", dict(n_layers=5), None),
                   ("rwkv6_7b", {}, None), ("seamless_m4t_large_v2", {}, None),
                   ("pixtral_12b", {}, None))


def _family_inputs(torch, mods, cfg, b, s, seed=SEED):
    """The prefill's inputs on the card: TokenStream tokens, plus the
    2048-frame source (seamless) or the 1024 patch embeddings ahead of
    s - 1024 tokens (pixtral), drawn from a seeded generator in bf16."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    n_tok = s - cfg.frontend_tokens if cfg.frontend == "vision" else s
    toks, _ = mods["TokenStream"](cfg.vocab, seed=seed).batch(b, n_tok)
    out = {"tokens": toks.to("cuda")}
    if cfg.is_encdec:
        out["src_embeds"] = torch.randn((b, s, cfg.d_model), generator=gen,
                                        device="cuda").to(dt)
    elif cfg.frontend == "vision":
        out["embeds"] = torch.randn((b, cfg.frontend_tokens, cfg.d_model),
                                    generator=gen, device="cuda").to(dt)
    return out


def _family_logits(tfm, params, cfg, inp):
    """Prefill, then the last position @ unemb: (B, vocab)."""
    hidden, _ = tfm.lm_forward(params, cfg, return_hidden=True, **inp)
    return hidden[:, -1] @ params["unemb"]


def _family_serve(torch, mods, label, cfg, want_launches):
    """Serves ``cfg`` (bf16, seed-0 weights) at full depth: a counted
    prefill (exactly ``want_launches`` flash launches, no other kernel),
    cold and median ms, its last-position logits against the plain version
    on the card, the first flash launch timed beside SDPA, then greedy
    decode steps through make_serve_step's step (the caches are the
    reference's stand-in: zeros for the prompt, which lm_forward does not
    return)."""
    tfm, flash, ops = mods["tfm"], mods["flash"], mods["ops"]
    graph_agg = mods["graph_agg"]
    b, s = FAMILY_B, FAMILY_S
    depth = s + FAMILY_DECODE_STEPS
    _, step = mods["make_serve_step"](
        cfg, mods["InputShape"]("serve", depth, b, "decode"), device="cuda")
    params, init_ms = _host_ms(torch, lambda: tfm.init_lm(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda"))
    n_params = sum(t.numel() for t in mods["tree_leaves"](params))
    inp = _family_inputs(torch, mods, cfg, b, s)
    torch.cuda.reset_peak_memory_stats()        # the prefill's, not init's
    fwd = lambda: _family_logits(tfm, params, cfg, inp)
    positions = b * (2 * s if cfg.is_encdec else s)
    out = {}
    with torch.inference_mode():
        _zero_counts(graph_agg)                          # ---- counted run
        logits, cold_ms = _host_ms(torch, fwd)
        counts = _counts(graph_agg)                      # ---- read counts
        launches = counts.pop("flash_attention_cuda")
        if launches != want_launches or any(counts.values()):
            raise AssertionError(f"{label} prefill: {launches} flash launches"
                                 f" (want {want_launches}), others {counts}")
        if logits.shape != (b, cfg.vocab) or \
                not bool(logits.float().isfinite().all()):
            raise AssertionError(f"{label}: bad prefill logits "
                                 f"{tuple(logits.shape)}")
        med = statistics.median(_host_ms(torch, fwd)[1]
                                for _ in range(FAMILY_PREFILL_REPS))
        plain = lambda q, k, v, **kw: flash.flash_attention_plain(q, k, v,
                                                                  **kw)
        with _swapped(ops, "flash_attention_cuda", plain):
            want = fwd()
        err = float((logits.float() - want.float()).abs().max())
        if err > PREFILL_LOGIT_ATOL:
            raise AssertionError(f"{label}: prefill logits through the kernel"
                                 f" vs the plain version: max abs diff "
                                 f"{err:.3e} > {PREFILL_LOGIT_ATOL}")
        peak = torch.cuda.max_memory_allocated()
        launch_txt = "no flash launch (the reference's path runs none)"
        if want_launches:
            with _Capture(ops, "flash_attention_cuda", limit=1) as cap:
                fwd()
            out["launch"] = _flash_launch(torch, flash, cap.calls[0],
                                          f"{label} flash launch")
            launch_txt = "the first launch " + _launch_text(out["launch"])
        src = f" (source) + {s} (target)" if cfg.is_encdec else ""
        print(f"families: {label} serve {cfg.name}, {n_params} parameters "
              f"(drawn on the card in {init_ms:.1f} ms), prefill B={b} S={s}"
              f"{src}: {launches} flash launches, cold {cold_ms:.1f} ms, "
              f"median of {FAMILY_PREFILL_REPS} {med:.1f} ms "
              f"({positions / med * 1e3:.0f} positions/s); last-position logits vs the plain version on "
              f"the card: max abs diff {err:.3e} (<= {PREFILL_LOGIT_ATOL}); "
              f"peak device memory {_gib(peak)}; {launch_txt}")

        enc = tfm.encode(params, cfg, inp["src_embeds"]) \
            if cfg.is_encdec else None
        caches = tfm.init_caches(cfg, b, depth, prefill_len=s, device="cuda")
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        step_ms, gen = [], []
        _zero_counts(graph_agg)
        for _ in range(FAMILY_DECODE_STEPS):
            (tok, caches), t = _host_ms(torch, lambda: step(params, caches,
                                                            tok, enc))
            step_ms.append(t)
            gen.append(tok)
        dcounts = _counts(graph_agg)
        gen = torch.cat(gen, dim=1)
        pos = [c.pos for c in caches.values() if hasattr(c, "pos")]
        if any(dcounts.values()) or not all(bool((p == depth).all())
                                            for p in pos) or \
                not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
            raise AssertionError(f"{label} decode: launches {dcounts}, "
                                 f"positions {[p.tolist() for p in pos]}")
        dmed = statistics.median(step_ms)
        print(f"families: {label} decode {FAMILY_DECODE_STEPS} greedy steps, "
              f"B={b}, positions {s}..{depth - 1}: median {dmed:.3f} ms a "
              f"step ({b / dmed * 1e3:.0f} tokens/s), first {step_ms[0]:.3f} "
              f"ms; no kernel launch")
    del params, caches, inp, enc
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"families: {label} device memory still allocated after the model"
          f" is dropped: {_gib(held)}")
    out.update(launches=launches, cold_ms=cold_ms, prefill_ms=med,
               logit_err=err, decode_ms=dmed, peak=peak, held=held)
    return out


def _family_train(torch, mods, label, cfg, b, s):
    """FAMILY_TRAIN_STEPS AdamW steps (bf16, remat, plain attention) on one
    synth_train_batch batch at the published widths: finite losses, no
    kernel launch; step ms, tokens/s, peak memory."""
    batch = mods["synth_train_batch"](
        cfg, mods["InputShape"]("train", s, b, "train"), seed=SEED)
    batch = {k: v.to("cuda") for k, v in batch.items()}
    state, _, losses, _, ms, peak = _train_run(
        torch, mods, cfg, batch, FAMILY_TRAIN_STEPS, f"{label} training")
    n_params = sum(t.numel() for t in mods["tree_leaves"](state.params))
    tokens = b * (2 * s if cfg.is_encdec else s)
    _steps_line(f"{label} encoder {cfg.enc_layers} + decoder"
                if cfg.is_encdec else label, cfg, n_params, tokens, losses,
                ms, peak, prefix="families")
    del state, batch
    torch.cuda.empty_cache()
    return dict(ms=statistics.median(ms[1:]), peak=peak, n_params=n_params,
                n_layers=cfg.n_layers)


def _families_card_vs_cpu(torch, mods):
    """Each family's reduced config in fp32: the prefill logits on the card
    against the CPU (plain attention), then one momentum-SGD train step
    (loss and every gradient), at GRAD_TOL."""
    tfm, base = mods["tfm"], mods["base"]
    for arch, over, _ in FAMILY_CARD_CPU:
        cfg = base.get_reduced(arch).with_(**over)
        params = tfm.init_lm(torch.Generator().manual_seed(SEED), cfg, "cpu")
        inp = {k: v.float().cpu() if v.is_floating_point() else v.cpu()
               for k, v in _family_inputs(torch, mods, cfg, 2, 64).items()}
        with torch.inference_mode():
            want, _ = tfm.lm_forward(params, cfg, **inp)
            got, _ = tfm.lm_forward(
                mods["tree_map"](lambda t: t.to("cuda"), params), cfg,
                **{k: v.to("cuda") for k, v in inp.items()})
        err = float((got.cpu() - want).abs().max())
        if not torch.allclose(got.cpu(), want, **GRAD_TOL):
            raise AssertionError(f"{cfg.name} fp32 prefill card vs CPU: "
                                 f"{err:.3e}")
        print(f"families: {cfg.name} fp32 prefill card vs CPU: max abs diff "
              f"{err:.3e} (rtol = atol = 1e-4)")
    _train_card_vs_cpu(torch, mods, FAMILY_CARD_CPU, prefix="families")


def phase_families(torch, mods):
    """The five families at their published widths: served at full depth
    (one model on the card at a time), trained at the cut depths, and held
    to the CPU in fp32 at their reduced configs."""
    out, part_s, t0 = {}, {}, time.perf_counter()
    for label, (make, launches, cut, b, s) in FAMILIES.items():
        out[label] = _family_serve(torch, mods, label, make(use_flash=True),
                                   launches)
        out[label]["train"] = _family_train(torch, mods, label,
                                            make(**cut), b, s)
        part_s[label] = time.perf_counter() - t0
        t0 = time.perf_counter()
    _families_card_vs_cpu(torch, mods)
    part_s["card vs CPU"] = time.perf_counter() - t0
    print("families: host seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in part_s.items()))
    return out


def _replay(torch, captured, cuda_fn, plain_fn, bound_fn):
    """Per-launch numbers of a kernel on exactly the inputs the main path
    gave it: max abs error, device ms, host-inclusive ms, plain ms, bound."""
    rows = []
    for i, (args, kw) in enumerate(captured):
        got = cuda_fn(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - plain_fn(*args, **kw)).abs().max())
        if err > KERNEL_ATOL or not torch.isfinite(got).all():
            raise AssertionError(f"main-path launch {i}: max abs err "
                                 f"{err:.3e} > {KERNEL_ATOL:.0e}")
        kernel = lambda: cuda_fn(*args, **kw)
        bound_ms, bound_by, _, _ = bound_fn(torch, *args)
        rows.append(dict(n_src=args[0].shape[1], n_dst=got.shape[1],
                         max_abs_err=err, ms=_time_ms(torch, kernel),
                         launch_ms=_time_ms(torch, kernel, preload=False),
                         plain_ms=_time_ms(torch, lambda: plain_fn(*args,
                                                                   **kw)),
                         bound_ms=bound_ms, bound_by=bound_by))
    return rows


def _empty_launch(torch):
    """The yardstick of a bare launch: device time and host-inclusive time
    of one PyTorch op on a one-element tensor, timed as every kernel here
    is (_time_ms). The port never calls it."""
    one = torch.zeros(1, device="cuda")
    return dict(ms=_time_ms(torch, lambda: one.add_(1.0)),
                launch_ms=_time_ms(torch, lambda: one.add_(1.0),
                                   preload=False),
                op="torch.Tensor.add_ on a 1-element float32 tensor")


def _sums(rows):
    by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    by_ops = sum(r["bound_ms"] for r in rows) - by_bytes
    return dict(ms=sum(r["ms"] for r in rows),
                launch_ms=sum(r["launch_ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=sum(r["bound_ms"] for r in rows),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def phase_result(torch, graph_agg, trained, served, powerlaw, n_layers, lm,
                 flash32k, flash_cases, backends):
    """The kernels line: each kernel timed on the inputs the training path
    gave it in one joint inference (the launches of its preset's counted
    200-round run); GCNII and GAT also on one cold answer of the serving
    path; the CSR kernel on the input one cold 16-query answer of the
    million-node serving path gave it (the launches of that counted run);
    the flash kernel on the first layer's input of the counted dense
    SmolLM-360M prefill, and at the 32k shape. ``backends`` adds the
    GCNII launches of the simulation and sharded phases' counted runs."""
    scope = (f"sum over the {n_layers} launches of one joint inference of a "
             "training round of {preset} (M=3, d=64, F+1=4, n_src/n_dst "
             "512/512, 512/512, 512/64, 64/16); ms, plain_ms: device time; "
             "launch_ms: with the host's enqueue time; launches: the "
             "preset's counted 200-round Trainer run")
    gather_note = "no single PyTorch call computes the masked gather-mean " \
                  "with the fused matmul"
    floor = _empty_launch(torch)
    print(f"result: empty-launch floor {floor['ms']:.4f} ms device, "
          f"{floor['launch_ms']:.4f} ms with the host ({floor['op']}; a "
          "yardstick the port never calls)")
    entries = []
    for name, fn, plain, bound, source, replaces, note in (
            ("graph_agg", graph_agg.graph_agg_cuda, graph_agg.graph_agg_plain,
             _gcn_bound, "src/repro_torch/kernels/csrc/graph_agg.cu",
             "src/repro/kernels/graph_agg.py:103", gather_note),
            ("gcnii_layer", graph_agg.gcnii_layer_cuda,
             graph_agg.gcnii_layer_plain, _gcnii_bound,
             "src/repro_torch/kernels/csrc/gcnii_layer.cu",
             "src/repro/kernels/graph_agg.py:256", gather_note),
            ("gat_layer", graph_agg.gat_layer_cuda,
             graph_agg.gat_layer_plain, _gat_bound,
             "src/repro_torch/kernels/csrc/gat_layer.cu",
             "src/repro/kernels/graph_agg.py:342", GAT_LIBRARY_NOTE)):
        preset, run = next((p, r) for p, r in trained.items()
                           if r["kernel"] == name)
        rows = _replay(torch, run["captured"], fn, plain, bound)
        entry = dict(name=name, route="cuda", source=source,
                     replaces=replaces, launches=run["launches"],
                     max_abs_err=max(r["max_abs_err"] for r in rows),
                     **_sums(rows), library_ms=None, library_note=note,
                     scope=scope.format(preset=preset), per_launch=rows,
                     empty_launch=floor)
        print(f"result: {name} training, per launch (device ms / with the "
              "host): " + ", ".join(
                  f"{r['n_src']}->{r['n_dst']} {r['ms']:.4f} / "
                  f"{r['launch_ms']:.4f}" for r in rows)
              + f"; sum {entry['ms']:.4f} / {entry['launch_ms']:.4f}")
        if f"{name}_cuda" in served:
            serve_launches, serve_captured = served[f"{name}_cuda"]
            serve_rows = _replay(torch, serve_captured, fn, plain, bound)
            cold = _sums(serve_rows[:n_layers])
            print(f"result: {name} serving, per launch of a cold answer "
                  "(device ms): " + ", ".join(
                      f"{r['n_src']}->{r['n_dst']} {r['ms']:.4f}"
                      for r in serve_rows[:n_layers])
                  + f"; sum {cold['ms']:.4f}")
            entry.update(
                max_abs_err=max(entry["max_abs_err"],
                                max(r["max_abs_err"] for r in serve_rows)),
                serve_launches=serve_launches,
                serve_cold_answer={k: cold[k] for k in
                                   ("ms", "launch_ms", "plain_ms", "bound_ms",
                                    "bound_by")},
                serve_per_launch=serve_rows)
        if name == "gcnii_layer":
            entry.update(backends)
        entries.append(entry)
    launches, captured = powerlaw
    rows = _replay(torch, captured, graph_agg.graph_agg_csr_cuda,
                   graph_agg.graph_agg_csr_plain, _csr_bound)
    entries.append(dict(
        name="graph_agg_csr", route="cuda",
        source="src/repro_torch/kernels/csrc/graph_agg_csr.cu",
        replaces="src/repro/kernels/graph_agg.py:192", launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows), **_sums(rows),
        library_ms=None, library_note=CSR_LIBRARY_NOTE,
        sparse_mm_two_calls_ms=_sparse_mm_ms(torch, graph_agg,
                                             *captured[0][0]),
        scope=(f"the {len(rows)} launch(es) of one cold 16-query answer of "
               f"{POWERLAW_PRESET} on powerlaw-1m (layer 0: M=2, n_src 67600"
               " -> n_dst 1040, F+1=33, d=d_out=32); ms, plain_ms: device "
               "time; launch_ms: with the host's enqueue time; launches: "
               "the counted serving run (cold 16-query, warm, cold 1-query "
               "answers)"),
        per_launch=rows))
    entries.append(_flash_entry(torch, lm, flash32k, flash_cases))
    print(json.dumps({"kernels": entries}))


def _flash_entry(torch, lm, flash32k, flash_cases):
    """The flash kernel on the main path's own input: the first layer's
    q, k, v of the counted dense SmolLM-360M prefill; beside it the 32k
    launch and the fp32 kernel at one of the reference's shapes."""
    from repro_torch.kernels import flash_attention as flash
    (args, kw), = lm["dense"]["captured"]
    q, k, v = args
    got = flash.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    err, excess = _check_flash_bf16(
        "flash main-path launch", got,
        flash.flash_attention_plain(q, k, v, **kw))
    b, s, h, dh = q.shape
    bound_ms, bound_by, _, flops = _flash_bound(
        b, s, k.shape[1], h, k.shape[2], dh, kw["causal"], kw["window"],
        "bfloat16")
    ms = _time_ms(torch, lambda: flash.flash_attention_cuda(q, k, v, **kw),
                  reps=10)
    return dict(
        name="flash_attention", route="cuda",
        route_detail=("bf16: flash_attention_kernel_mma, tensor cores "
                      "(mma.sync m16n8k16 bf16 -> fp32 for q.k^T and for "
                      "p.v with P split into bf16 hi + lo, ldmatrix, K/V "
                      "tiles by cp.async into a two-stage ring); fp32: "
                      "flash_attention_kernel_f32, CUDA cores (fp32 FMA); "
                      "an explicit dispatch on the dtype, no fallback"),
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:69",
        launches=lm["dense"]["launches"],
        glasu_launches=lm["glasu"]["launches"],
        moe_launches=lm["train"]["moe_serve"]["launches"],
        family_launches={label: fam["launches"]
                         for label, fam in lm["families"].items()},
        max_abs_err=err,
        tolerance=(f"|err| <= 2^-7 |plain| + {FLASH_BF16_ATOL:.0e} (one bf16 "
                   f"rounding; reading {excess:.3e} over 2^-7 |plain|)"),
        bf16_excess=excess,
        bf16_worst_excess_all_cases=flash_cases["bf16_worst_excess"],
        ms=ms, tflops=flops / ms / 1e9, bound_share=bound_ms / ms,
        plain_ms=_time_ms(torch, lambda: flash.flash_attention_plain(
            q, k, v, **kw), reps=5),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=_time_ms(torch, lambda: _sdpa_library(torch, q, k, v,
                                                         kw["causal"])),
        library_call="torch.nn.functional.scaled_dot_product_attention("
                     "is_causal=True, enable_gqa=True)",
        scope=(f"one launch on the main path's input: layer 0 of the counted"
               f" dense SmolLM-360M prefill (B {b}, S = T = {s}, H {h}, Kv "
               f"{k.shape[2]}, dh {dh}, bf16, causal); ms, plain_ms, "
               "library_ms: device time; tflops: 4·dh flops a visible (query,"
               " key) pair and head over ms; launches: the counted dense "
               "prefill (glasu_launches: the GLASU split's; moe_launches: "
               "the 2-layer phi3.5-moe prefill's; family_launches: each "
               "family's full-depth B 2 x S 2048 prefill)"),
        at_32k=flash32k, fp32_kernel=flash_cases["fp32"],
        at_moe_prefill=lm["train"]["moe_serve"]["launch"],
        at_family_prefill={label: fam["launch"]
                           for label, fam in lm["families"].items()
                           if "launch" in fam})


PHASE_S = {}


def _timed(name, fn, *args):
    """``fn(*args)``, its host seconds kept under ``name`` for the time
    line."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = PHASE_S.get(name, 0.0) + time.perf_counter() - t0
    return out


def main() -> int:
    t_main = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU (CUDA)", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.api import (ExperimentConfig, Hook, Trainer, get_preset,
                                 make_backend)
    from repro_torch.api.backends import run_step_sequential
    from repro_torch.fed.simulation import MessageLog, log_agg_traffic
    from repro_torch.comm.compression import make_compressor
    from repro_torch.fed.faults import FaultSchedule
    from repro_torch.core import glasu
    from repro_torch.graph import csr_plan
    from repro_torch.graph.prefetch import sample_rounds, unstack_round
    from repro_torch.graph.sampler import GlasuSampler, batch_to_device
    from repro_torch.graph.synth import make_powerlaw_dataset, make_vfl_dataset
    from repro_torch.configs.base import GlasuSplit, InputShape
    from repro_torch.configs import base
    from repro_torch.core import steps
    from repro_torch.core.steps import make_serve_step, make_train_step
    from repro_torch.data.pipeline import synth_train_batch
    from repro_torch.models import moe
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels import build, graph_agg, ops
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.serve import InferenceSession, ServeConfig
    from repro_torch.tree import tree_leaves, tree_map

    _timed("device", phase_device, torch)
    _timed("build", phase_build, build)
    _timed("kernels", phase_kernels, torch, graph_agg)
    _timed("kernels", phase_kernels_gcn, torch, graph_agg)
    _timed("kernels", phase_kernels_gat, torch, graph_agg)
    _timed("kernels", phase_kernels_csr, torch, np, graph_agg, csr_plan)
    flash_cases = _timed("kernels", phase_kernels_flash, torch, flash)
    _timed("kernels", phase_grads, torch, ops)
    _timed("kernels", phase_grads_csr, torch, np, ops, csr_plan)
    mods = dict(glasu=glasu, graph_agg=graph_agg, ops=ops,
                get_preset=get_preset, make_vfl_dataset=make_vfl_dataset,
                make_powerlaw_dataset=make_powerlaw_dataset, Hook=Hook,
                InferenceSession=InferenceSession, ServeConfig=ServeConfig,
                Trainer=Trainer, GlasuSampler=GlasuSampler,
                sample_rounds=sample_rounds, unstack_round=unstack_round,
                batch_to_device=batch_to_device,
                make_optimizer=make_optimizer, tree_leaves=tree_leaves,
                tree_map=tree_map, tfm=tfm, attn=attn, flash=flash,
                make_serve_step=make_serve_step, InputShape=InputShape,
                TokenStream=TokenStream, ExperimentConfig=ExperimentConfig,
                make_compressor=make_compressor, FaultSchedule=FaultSchedule,
                make_backend=make_backend,
                run_step_sequential=run_step_sequential,
                MessageLog=MessageLog, log_agg_traffic=log_agg_traffic,
                make_train_step=make_train_step, steps=steps, moe=moe,
                GlasuSplit=GlasuSplit, base=base,
                synth_train_batch=synth_train_batch)
    served = {kernel: _timed("slice", phase_slice, torch, np, mods, name,
                             kernel)
              for name, kernel in SERVE_PRESETS.items()}
    trained = _timed("train", phase_train, torch, mods)
    hot_data = make_vfl_dataset(COMP_HOT["dataset"],
                                n_clients=COMP_HOT["n_clients"], seed=SEED)
    comp = _timed("comp", phase_comp_train, torch, mods, hot_data)
    _timed("fault", phase_fault_train, torch, mods, hot_data, comp["none"])
    _timed("resume", phase_resume, torch, mods, hot_data)
    _timed("serve-comp", phase_comp_serve, torch, np, mods)
    sim = _timed("sim", phase_sim, torch, mods)
    sharded = _timed("sharded", phase_sharded, torch, np, mods)
    import torch.distributed as dist
    if dist.is_initialized():
        raise AssertionError("the sharded phases closed every backend, "
                             "trainer and session, yet a default process "
                             "group is still alive")
    powerlaw = _timed("powerlaw", phase_powerlaw, torch, np, mods)
    split = smollm_config(glasu=GlasuSplit(n_clients=5, sync_every=2,
                                           local_steps=1))
    lm = {"dense": _timed("serve", phase_serve_lm, torch, mods, "dense",
                          smollm_config(), 32),
          "glasu": _timed("serve", phase_serve_lm, torch, mods, "glasu",
                          split, 16)}
    lm["train"] = _timed("train_lm", phase_train_lm, torch, mods)
    lm["families"] = _timed("families", phase_families, torch, mods)
    flash32k = _timed("flash32k", phase_flash_32k, torch, flash)
    _timed("result", phase_result, torch, graph_agg, trained, served,
           powerlaw, get_preset("cora-gcnii-glasu").n_layers, lm, flash32k,
           flash_cases, dict(
               sim_launches_per_round=sim["launches_per_round"],
               sharded_launches=sharded["launches"],
               sharded_serve_launches=sharded["serve_launches"]))
    print(f"time: main() ran {time.perf_counter() - t_main:.1f} s (host "
          "clock, from its start, the build included); by phase " +
          ", ".join(f"{k} {v:.1f}" for k, v in PHASE_S.items()) + " s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
