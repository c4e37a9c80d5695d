"""The card's peaks and each kernel launch's least possible time.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 67 TFLOP/s in
float32 outside the tensor cores and 3.35 TB/s of HBM, both at the full
700 W power limit. Both GNN configurations compute in float32 with TF32
off, so the float32 rate is their peak. ``power_limit_w`` reads the card's
limit, which is reported beside every share of a peak.

A launch's bound is the larger of its bytes over the bandwidth and its
operations over the peak: each input byte read once (of a gathered source
only the rows that live slots name), each output byte written once, and
the operations that the live slots need.
"""
from __future__ import annotations

import subprocess
from typing import Optional

import torch

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def power_limit_w() -> Optional[float]:
    """The card's power limit in watts, from ``nvidia-smi``; None where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def bound_s(nbytes: int, flops: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def _live_rows(idx, live) -> int:
    return sum(int(torch.unique(idx[c][live[c]]).numel())
               for c in range(idx.shape[0]))


def gcnii_bound(h_shape, idx, mask, w_shape, saved: bool) -> tuple:
    """(bytes, flops) of one GCNII launch: of h and h0 the rows the live
    slots and the self column name, the tables, W and b, the output (and
    z where the launch saves it)."""
    m, n_dst, _ = idx.shape
    d = h_shape[2]
    live = mask != 0
    rows_h = _live_rows(idx, live)
    rows_h0 = sum(int(torch.unique(idx[c, :, 0]).numel()) for c in range(m))
    out_bytes = m * n_dst * d * 4 * (2 if saved else 1)
    nbytes = ((rows_h + rows_h0) * d * 4 + idx.numel() * 4
              + mask.numel() * 4 + (w_shape[0] * w_shape[1] * w_shape[2]
                                    + m * d) * 4 + out_bytes)
    flops = (2 * int(live.sum()) * d + 4 * m * n_dst * d
             + 2 * m * n_dst * d * d + 5 * m * n_dst * d)
    return nbytes, flops


def graph_agg_bound(h_shape, idx, mask, w_shape, saved: bool) -> tuple:
    """(bytes, flops) of one GCN aggregation launch: of h the rows the live
    slots name, the tables, W, the output (and the mean where saved)."""
    m, n_dst, _ = idx.shape
    d, d_out = w_shape[1], w_shape[2]
    live = mask != 0
    rows_h = _live_rows(idx, live)
    out_bytes = m * n_dst * (d_out + (d if saved else 0)) * 4
    nbytes = (rows_h * d * 4 + idx.numel() * 4 + mask.numel() * 4
              + w_shape[0] * d * d_out * 4 + out_bytes)
    flops = (2 * int(live.sum()) * d + m * n_dst * d
             + 2 * m * n_dst * d * d_out)
    return nbytes, flops


def csr_bound(h_shape, idx_slab, seg_slab, ew_slab, w_shape, n_dst: int,
              saved: bool) -> tuple:
    """(bytes, flops) of one CSR segment-mean launch: each slab once, of h
    the rows the live slots (local row in [0, 128), weight != 0) name, W,
    the output (and the mean where saved)."""
    m, d = h_shape[0], h_shape[2]
    d_out = w_shape[2]
    live = (seg_slab >= 0) & (seg_slab < 128) & (ew_slab != 0)
    rows_h = _live_rows(idx_slab, live)
    n_live = int(live.sum())
    out_bytes = m * n_dst * (d_out + (d if saved else 0)) * 4
    nbytes = (rows_h * d * 4 + 3 * idx_slab.numel() * 4
              + w_shape[0] * d * d_out * 4 + out_bytes)
    flops = (2 * n_live * d + n_live + m * n_dst * d
             + 2 * m * n_dst * d * d_out)
    return nbytes, flops
