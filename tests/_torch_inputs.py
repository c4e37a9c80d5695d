"""Seeded numpy inputs shared by the port's kernel tests (CPU and card).

Imports neither jax nor ``repro``, so the card rows can run on a machine
without the reference package.
"""
import numpy as np


def gcnii_inputs(seed, m, n_src, n_dst, f1, d, case="plain"):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(m, n_src, d)).astype(np.float32)
    h0 = rng.normal(size=(m, n_src, d)).astype(np.float32)
    idx = rng.integers(0, n_src, size=(m, n_dst, f1)).astype(np.int32)
    mask = (rng.random((m, n_dst, f1)) < 0.8).astype(np.float32)
    mask[:, :, 0] = 1.0                      # self column, as the plans set it
    if case == "ragged":
        mask[:, ::3, :] = 0.0                # zero-degree rows
        mask[:, 1::3, 0] = 0.0               # mask[:, 0] = 0: h0 still read
    w = (rng.normal(size=(m, d, d)) / np.sqrt(d)).astype(np.float32)
    b = rng.normal(size=(m, d)).astype(np.float32)
    return h, h0, idx, mask, w, b


GCNII_CASES = [
    # m, n_src, n_dst, f1, d, case, alpha, beta
    (3, 300, 130, 4, 64, "plain", 0.1, 0.25),     # n_dst % 128 != 0
    (2, 80, 1, 6, 24, "plain", 0.3, 0.125),       # n_dst = 1, d = 24
    (3, 90, 77, 9, 24, "ragged", 0.2, 0.5),       # zero rows, mask[:, 0] = 0
    (3, 2708, 40, 33, 64, "plain", 0.1, 0.5 / 3),  # cora's source set, W = 33
    # the CUDA kernel's edges: self only, four whole batches of 16 entries,
    # W of 64 KB (the shared-memory opt-in), fewer rows than a block owns
    (2, 40, 12, 1, 16, "plain", 0.1, 0.5),        # F+1 = 1
    (2, 80, 10, 64, 16, "ragged", 0.2, 0.25),     # F+1 = 64
    (2, 60, 20, 5, 128, "plain", 0.1, 0.5),       # d = 128
    (3, 30, 3, 4, 64, "plain", 0.1, 0.125),       # n_dst = 3
    (2, 40, 15, 5, 7, "plain", 0.1, 0.5),         # d = 7: scalar columns,
                                                  # W not 16-byte sized
]


def gcnii_grad_inputs(seed, m, n_src, n_dst, f1, d, case="plain"):
    """A GCNII forward's inputs for its backward. case "dup" lays a level
    out as the sampler does: 60 % of the fanout slots masked and pointing
    at row 0, and the last quarter of the rows padding (mask all 0, every
    slot, the self column too, at row 0), so row 0 takes over half the
    entries."""
    h, h0, idx, mask, w, b = gcnii_inputs(
        seed, m, n_src, n_dst, f1, d, "ragged" if case == "ragged" else
        "plain")
    if case == "dup":
        rng = np.random.default_rng(seed + 1000)
        mask[:, :, 1:] = rng.random((m, n_dst, f1 - 1)) < 0.4
        idx[mask == 0] = 0
        pad = n_dst - n_dst // 4
        mask[:, pad:] = 0.0
        idx[:, pad:] = 0
    return h, h0, idx, mask, w, b


GCNII_GRAD_CASES = [
    # m, n_src, n_dst, f1, d, case
    (3, 512, 512, 4, 64, "dup"),       # the main path: levels 0-1
    (3, 512, 64, 4, 64, "dup"),        # 512 -> 64
    (3, 64, 16, 4, 64, "dup"),         # 64 -> 16
    (1, 512, 512, 4, 64, "dup"),       # one client
    (2, 40, 15, 5, 7, "plain"),        # d = 7: scalar columns
    (3, 90, 77, 9, 24, "ragged"),      # zero rows, mask[:, 0] = 0
    (2, 60, 20, 5, 128, "plain"),      # d = 128
    (2, 80, 10, 64, 16, "ragged"),     # F+1 = 64
    (2, 40, 12, 1, 16, "plain"),       # F+1 = 1
    (3, 2708, 40, 33, 64, "plain"),    # cora's source set, W = 33
]


def gcn_inputs(seed, m, n_src, n_dst, f1, d, d_out, ragged=False):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(m, n_src, d)).astype(np.float32)
    idx = rng.integers(0, n_src, size=(m, n_dst, f1)).astype(np.int32)
    if f1 >= 3:
        idx[:, :, 1] = idx[:, :, 2]          # repeated sources in a fanout
    mask = (rng.random((m, n_dst, f1)) < 0.75).astype(np.float32)
    if ragged:
        mask[:, ::3, :] = 0.0                # zero-degree rows
    w = (rng.normal(size=(m, d, d_out)) / np.sqrt(d)).astype(np.float32)
    return h, idx, mask, w


GCN_CASES = [
    # m, n_src, n_dst, f1, d, d_out, ragged
    (3, 200, 130, 4, 64, 64, True),          # n_dst % 128 != 0, zero rows
    (3, 150, 77, 4, 192, 64, False),         # concat width 192 -> 64
    (2, 40, 1, 3, 24, 8, True),              # n_dst = 1
    # the CUDA kernel's edges: self only, four whole batches of 16 entries,
    # scalar columns with W not 16-byte sized, W of 64 KB, the fewest rows,
    # and the million-node preset's training widths
    (2, 40, 12, 1, 16, 8, False),            # F+1 = 1
    (2, 80, 10, 64, 16, 16, True),           # F+1 = 64
    (2, 40, 15, 5, 7, 7, False),             # d = d_out = 7
    (2, 60, 20, 5, 128, 128, False),         # d = 128
    (3, 64, 16, 4, 64, 64, False),           # n_dst = 16
    (2, 256, 64, 4, 32, 32, False),          # powerlaw layer 0
    (2, 64, 16, 4, 32, 16, True),            # powerlaw layer 1
]


def gat_inputs(seed, m, n_src, n_dst, f1, d, heads, dh, case="plain"):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(m, n_src, d)).astype(np.float32)
    idx = rng.integers(0, n_src, size=(m, n_dst, f1)).astype(np.int32)
    mask = (rng.random((m, n_dst, f1)) < 0.8).astype(np.float32)
    mask[:, :, 0] = 1.0                      # self column, as the plans set it
    if case == "masked":
        mask[:, ::3, :] = 0.0                # fully-masked rows: out = elu(b)
        mask[:, 1::3, 0] = 0.0               # self masked, its score still read
    w = (rng.normal(size=(m, d, heads, dh)) * 0.2).astype(np.float32)
    a_src = (rng.normal(size=(m, heads, dh)) * 0.1).astype(np.float32)
    a_dst = (rng.normal(size=(m, heads, dh)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(m, heads * dh)) * 0.1).astype(np.float32)
    return h, idx, mask, w, a_src, a_dst, b


GAT_CASES = [
    # m, n_src, n_dst, f1, d, heads, dh, case: the reference's kernel-test
    # shapes (tests/test_kernels.py), then masked rows at the main path's
    # widths
    (2, 64, 32, 5, 16, 2, 8, "plain"),
    (3, 300, 130, 4, 64, 2, 32, "plain"),    # n_dst % 128 != 0
    (2, 256, 77, 5, 96, 4, 16, "plain"),     # 4 heads
    (2, 200, 129, 9, 48, 1, 64, "plain"),    # one head, dh = 64, wide fanout
    (3, 90, 77, 4, 64, 2, 32, "masked"),     # all-masked rows, mask[:, 0] = 0
    (3, 120, 40, 33, 64, 2, 32, "masked"),   # the eval fanout, W = 33 > 32
    # the CUDA kernel's lane-group edges: one lane a row (self only), a
    # 32-lane group over two batches, two entries a lane with a narrow head,
    # fewer rows than a block owns
    (2, 40, 12, 1, 16, 2, 8, "plain"),       # F+1 = 1
    (2, 60, 20, 17, 16, 2, 8, "masked"),     # F+1 = 17
    (2, 80, 10, 64, 16, 1, 8, "plain"),      # F+1 = 64, H = 1, dh = 8
    (2, 30, 3, 4, 64, 2, 32, "plain"),       # n_dst = 3
    (2, 50, 20, 5, 7, 3, 6, "plain"),        # dh = 6: scalar columns, W of
                                             # 7 x 18 not 16-byte sized
]


def cotangent(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def rand_csr(seed, n_dst, n_src, max_deg=6, p_zero=0.3, hub=0):
    """Ragged host CSR: ~p_zero of the rows have no neighbors; with ``hub``
    row 0 has that many (a tuple: rows 0 and 3), so its tile's slab
    outgrows 128·33 slots."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, max_deg + 1, size=n_dst)
    deg[rng.random(n_dst) < p_zero] = 0
    for row, n in zip((0, 3), hub if isinstance(hub, tuple) else (hub,)):
        if n:
            deg[row] = n
    indptr = np.zeros(n_dst + 1, np.int32)
    indptr[1:] = np.cumsum(deg, dtype=np.int32)
    indices = rng.integers(0, n_src, size=int(indptr[-1])).astype(np.int32)
    return indptr, indices


def csr_weights(seed, nnz, kind):
    """None (unweighted), "rand" (0.25-1.25) or "low" (0.05-0.3: most rows'
    weights sum below 1, which the clamp must not renormalise)."""
    if kind == "none":
        return None
    rng = np.random.default_rng(seed)
    lo, hi = (0.25, 1.25) if kind == "rand" else (0.05, 0.3)
    return (lo + (hi - lo) * rng.random(nnz)).astype(np.float32)


def shuffle_slabs(seed, n_tiles, *slabs, order="shuffled"):
    """The same slab layout with the slots of every tile permuted (order
    "shuffled": edges of a row no longer contiguous or in row order, pads
    among the live slots), or of every odd tile only ("mixed": tiles in
    row order beside tiles out of it)."""
    rng = np.random.default_rng(seed)
    slab = slabs[0].shape[0] // n_tiles
    perms = [rng.permutation(slab) for _ in range(n_tiles)]
    perm = np.concatenate([
        t * slab + (p if order == "shuffled" or t % 2 else np.arange(slab))
        for t, p in enumerate(perms)]).astype(np.int32)
    return tuple(s[perm] for s in slabs)


CSR_CASES = [
    # label, n_dst, n_src, max_deg, p_zero, hub, weights
    ("ragged", 300, 64, 6, 0.3, 0, "none"),          # n_dst % 128 != 0
    ("weights below 1", 300, 64, 6, 0.3, 0, "low"),
    ("empty graph", 130, 16, 6, 1.0, 0, "none"),
    ("n_dst=1", 1, 40, 6, 0.0, 0, "rand"),
    ("hub tile", 200, 500, 6, 0.2, 6000, "rand"),    # slab 6144 > 128·33
    ("two hub rows", 200, 500, 6, 0.2, (300, 200), "rand"),
    ("mostly pads", 300, 64, 6, 0.7, 0, "rand"),     # pads among live slots
                                                     # once shuffled
    ("hub past one window", 200, 500, 6, 0.2, 9000, "rand"),  # slab > 8192
    ("nine tiles", 1100, 400, 6, 0.3, 0, "rand"),    # blocks of 8 rows: a
                                                     # warp sorts two each
]


def flash_inputs(seed, b, s, t, h, kv, dh, const_v=None):
    """q (b, s, h, dh), k and v (b, t, kv, dh), standard normal float32; v
    all ``const_v`` when given."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, t, kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, dh)).astype(np.float32)
    if const_v is not None:
        v = np.full_like(v, const_v)
    return q, k, v


FLASH_CASES = [
    # label, b, s, t, h, kv, dh, causal, window, dtype
    # the reference's four shapes (tests/test_kernels.py), both masks
    ("mha single block", 1, 128, 128, 4, 4, 32, True, None, "float32"),
    ("mha single block bidir", 1, 128, 128, 4, 4, 32, False, None, "float32"),
    ("gqa 4:1 multi-block", 2, 256, 256, 8, 2, 64, True, None, "float32"),
    ("gqa 4:1 bidir", 2, 256, 256, 8, 2, 64, False, None, "float32"),
    ("mqa ragged 200", 1, 200, 200, 4, 1, 64, True, None, "float32"),
    ("mqa ragged 200 bidir", 1, 200, 200, 4, 1, 64, False, None, "float32"),
    ("t > s causal", 2, 96, 320, 4, 2, 32, True, None, "float32"),
    ("t > s bidir", 2, 96, 320, 4, 2, 32, False, None, "float32"),
    # sliding windows (first visited kv tile fully masked for most rows)
    ("window 32", 1, 512, 512, 2, 2, 32, True, 32, "float32"),
    ("window 128", 1, 512, 512, 2, 2, 32, True, 128, "float32"),
    ("window 511", 1, 512, 512, 2, 2, 32, True, 511, "float32"),
    # dtypes
    ("bf16", 1, 128, 128, 2, 2, 64, True, None, "bfloat16"),
    ("bf16 gqa ragged", 2, 200, 200, 6, 2, 64, True, None, "bfloat16"),
    # head widths: reduced smollm (dh 80, GQA 3:1) and dh 128
    ("dh 80 gqa 3:1", 2, 200, 200, 3, 1, 80, True, None, "float32"),
    ("dh 80 bf16", 2, 200, 200, 3, 1, 80, True, None, "bfloat16"),
    ("dh 128", 1, 130, 130, 4, 2, 128, True, None, "float32"),
    # widths the bf16 kernel pads to a multiple of 16 (40 -> 48) or not (96),
    # and S, T that are multiples of no tile (8, 16, 64, 128)
    ("dh 40", 1, 150, 150, 4, 2, 40, True, None, "float32"),
    ("dh 96 bidir", 1, 140, 140, 2, 1, 96, False, None, "float32"),
    ("ragged s t", 1, 201, 333, 4, 2, 64, True, None, "float32"),
    ("ragged s t bidir", 1, 201, 333, 4, 2, 64, False, None, "float32"),
]
# every shape in both dtypes: the bf16 twin of each fp32 row (and the fp32
# twin of each bf16 row), so the bf16 tensor-core kernel sees the windows,
# ragged S and T, t > s, MQA and every head width
FLASH_CASES += [
    (f"{c[0]} bf16", *c[1:-1], "bfloat16") if c[-1] == "float32" else
    (c[0].replace("bf16", "fp32"), *c[1:-1], "float32")
    for c in FLASH_CASES if c[0] not in ("dh 80 gqa 3:1", "dh 80 bf16")]
