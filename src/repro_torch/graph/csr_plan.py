"""Host-side CSR planning for the sparse aggregation kernel.

Counterpart of ``repro.graph.csr_plan`` (numpy only, bitwise the same
layout). The CSR segment-sum kernel (``kernels/graph_agg.py``,
``graph_agg_csr_cuda``, replacing the reference's ``graph_agg_csr_pallas``)
consumes a padded row-tile *slab* layout; the sparse structure that
produces it is concrete host data — exactly like the sampler's
neighbor-table builds in ``graph.py`` — so the planning lives here, and
the kernel sees only the padded slab arrays.

Layout: tile i's edges occupy slots [i*slab, (i+1)*slab) of three
(n_tiles*slab, 1) arrays — ``idx`` the source id, ``seg`` the LOCAL
destination row in [0, 128) (``CSR_PAD_ROW`` marks padding slots),
``ew`` the edge weight (1.0 when unweighted, 0.0 on padding). ``slab``
is the max per-tile edge count rounded up to a lane multiple, so the
layout's overhead is bounded by tile skew (≈ 128·avg_deg + max_deg per
tile) — callers at graph scale feed a degree-capped CSR, the same
policy every neighbor table in the repo already applies
(``table_cap``/``eval_table_cap``).
"""
from __future__ import annotations

import numpy as np

from ..kernels.graph_agg import CSR_PAD_ROW, DST_BLOCK


def _as_indptr(indptr) -> np.ndarray:
    return np.asarray(indptr, dtype=np.int64)  # glint: disable=GL003 slot arithmetic below forms nnz*slab products that outgrow int32 at graph scale; host-only, never shipped to device


def csr_segments(indptr) -> np.ndarray:
    """(nnz,) int32 destination-row id per CSR edge (the segment ids the
    oracles sum over)."""
    indptr = _as_indptr(indptr)
    n_dst = len(indptr) - 1
    return np.repeat(np.arange(n_dst, dtype=np.int32), np.diff(indptr))


def csr_slot_map(indptr, total: int) -> np.ndarray:
    """(nnz,) int32 slab slot per CSR edge for a layout of ``total`` rows.

    Edges are CSR-ordered, so an edge's offset within its tile is its
    global position minus the tile's first edge position. Used to scatter
    per-edge tensors (differentiable edge weights) into the slab on the
    device while keeping the slot arithmetic on the host.
    """
    indptr = _as_indptr(indptr)
    n_dst = len(indptr) - 1
    nnz = int(indptr[-1])
    n_tiles = max(1, -(-n_dst // DST_BLOCK))
    slab = total // n_tiles
    rows = np.repeat(np.arange(n_dst, dtype=np.int64), np.diff(indptr))  # glint: disable=GL003 see _as_indptr: 64-bit slot headroom; host-only
    tile = rows // DST_BLOCK
    slot = (tile * slab + np.arange(nnz, dtype=np.int64)  # glint: disable=GL003 see _as_indptr: 64-bit slot headroom; host-only
            - indptr[tile * DST_BLOCK])
    return slot.astype(np.int32)


def plan_csr_slabs(indptr, indices, edge_weight=None):
    """Host CSR -> padded row-tile slab layout (concrete numpy).

    Returns ``(idx_slab, seg_slab, ew_slab, n_dst)`` shaped as in the
    module docstring.
    """
    indptr = _as_indptr(indptr)
    n_dst = len(indptr) - 1
    nnz = int(indptr[-1])
    n_tiles = max(1, -(-n_dst // DST_BLOCK))
    deg = np.diff(indptr)
    deg_pad = np.zeros(n_tiles * DST_BLOCK, np.int64)  # glint: disable=GL003 see _as_indptr: 64-bit slot headroom; host-only
    deg_pad[:n_dst] = deg
    tile_nnz = deg_pad.reshape(n_tiles, DST_BLOCK).sum(axis=1)
    slab = max(DST_BLOCK,
               int(-(-int(tile_nnz.max()) // DST_BLOCK) * DST_BLOCK))
    idx_slab = np.zeros((n_tiles * slab, 1), np.int32)
    seg_slab = np.full((n_tiles * slab, 1), CSR_PAD_ROW, np.int32)
    ew_slab = np.zeros((n_tiles * slab, 1), np.float32)
    if nnz:
        rows = np.repeat(np.arange(n_dst, dtype=np.int64), deg)  # glint: disable=GL003 see _as_indptr: 64-bit slot headroom; host-only
        slot = csr_slot_map(indptr, n_tiles * slab)
        idx_slab[slot, 0] = np.asarray(indices, np.int32)[:nnz]
        seg_slab[slot, 0] = (rows % DST_BLOCK).astype(np.int32)
        ew_slab[slot, 0] = (1.0 if edge_weight is None
                            else np.asarray(edge_weight, np.float32))
    return idx_slab, seg_slab, ew_slab, n_dst
