"""Port parity: flash attention against the JAX package, on the CPU.

The same numpy inputs go through ``repro``'s Pallas kernel
(``flash_attention_pallas`` in interpret mode, as ``tests/test_kernels.py``
runs it) and its jnp oracle, and through ``repro_torch``'s plain version and
torch oracle. Tolerances are the reference's own kernel tolerances: 2e-5
for fp32 (sums in another order) and 3e-2 for bf16 (one bf16 rounding of
the output, 2^-8 relative, and of the oracle's softmax weights). One row
holds the plain bf16 path to a single bf16 rounding of the fp32 oracle,
the bound ``chip_smoke.py`` uses at long sequences. The rows
that hold the CUDA kernel against the plain version live in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

from _torch_inputs import FLASH_CASES, flash_inputs

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _both(arrays, dtype):
    """The same arrays as jnp and torch tensors of ``dtype`` (both round
    fp32 -> bf16 to nearest even, so the bits agree)."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("label,b,s,t,h,kv,dh,causal,window,dtype",
                         FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_plain_matches_pallas_and_oracle(label, b, s, t, h, kv, dh,
                                               causal, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(flash_inputs(1, b, s, t, h, kv, dh),
                                       dtype)
    got = tflash.flash_attention_plain(tq, tk, tv, causal=causal,
                                       window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                      window=window)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL[dtype])
    mine = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert mine.dtype == tq.dtype
    np.testing.assert_allclose(_np(mine), _np(oracle), **TOL[dtype])


@pytest.mark.parametrize("s,h,g,dh,seed", [(16, 1, 1, 16, 0),
                                           (77, 2, 2, 32, 1),
                                           (200, 4, 2, 16, 2),
                                           (257, 4, 1, 32, 3)])
def test_flash_plain_constant_v_and_first_row(s, h, g, dh, seed):
    """Rows of the attention matrix sum to 1, so a constant v gives a
    constant output; the first causal row sees only itself."""
    q, k, _ = flash_inputs(seed, 1, s, s, h, h // g, dh, const_v=3.25)
    out = tflash.flash_attention_plain(
        *map(torch.from_numpy, (q, k, np.full_like(k, 3.25))), causal=True)
    np.testing.assert_allclose(out.numpy(), 3.25, rtol=1e-5, atol=1e-5)
    _, _, v = flash_inputs(seed + 100, 1, s, s, h, h // g, dh)
    out = tflash.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                       causal=True)
    np.testing.assert_allclose(out[:, 0].numpy(),
                               np.repeat(v[:, 0], g, axis=1), rtol=1e-6,
                               atol=1e-6)


def test_flash_plain_chunks_queries():
    """Past PLAIN_Q_CHUNK query rows the plain version works chunk by chunk
    and agrees with the oracle (t > s, window across a chunk border)."""
    q, k, v = flash_inputs(5, 1, tflash.PLAIN_Q_CHUNK + 70, 1200, 2, 1, 16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for causal, window in ((True, None), (False, None), (True, 100)):
        got = tflash.flash_attention_plain(tq, tk, tv, causal=causal,
                                           window=window)
        want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL["float32"])


# one bf16 rounding: two fp32 evaluations of the same attention, each rounded
# once to bf16, are at most one bf16 step (2^-7 of the value) apart, plus
# room for the fp32 sums' order. chip_smoke.py holds the kernel to this
# bound at its long shapes, where the reference's 3e-2 exceeds a typical
# output (~sqrt(e / S)).
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5


def _excess(got, want):
    """max(|got - want| - BF16_RTOL * |want|)."""
    got, want = _np(got), _np(want)
    return float((np.abs(got - want) - BF16_RTOL * np.abs(want)).max())


def test_flash_plain_bf16_within_one_rounding_of_the_fp32_oracle():
    q, k, v = flash_inputs(8, 1, 1024, 1024, 3, 1, 64)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "bfloat16")
    got = tflash.flash_attention_plain(tq, tk, tv, causal=True)
    # the reference's oracle in fp32 on the same bf16 values, rounded once
    want = np.array(jref.flash_attention_ref(
        *(x.astype(jnp.float32) for x in (jq, jk, jv)), causal=True))
    want = torch.from_numpy(want).bfloat16()
    assert _excess(got, want) <= BF16_ATOL
    # and it sees a version that drops a tenth of the keys of late rows
    dropped = tflash.flash_attention_plain(tq, tk, tv, causal=True,
                                           window=922)
    assert _excess(dropped, want) > 100 * BF16_ATOL


def test_ops_flash_attention_on_cpu_takes_the_plain_version():
    q, k, v = map(torch.from_numpy, flash_inputs(6, 2, 40, 40, 4, 2, 32))
    before = tflash.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, causal=True, window=16)
    assert torch.equal(got, tflash.flash_attention_plain(q, k, v, causal=True,
                                                         window=16))
    assert tflash.flash_attention_cuda.launches == before
    # the plain version is differentiable on the CPU
    q.requires_grad_(True)
    (dq,) = torch.autograd.grad(ops.flash_attention(q, k, v).sum(), q)
    assert dq.shape == q.shape and torch.isfinite(dq).all()


def test_flash_cuda_wrapper_and_ops_refuse_what_they_cannot_run():
    q, k, v = map(torch.from_numpy, flash_inputs(7, 1, 8, 8, 2, 1, 16))
    before = tflash.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        tflash.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert tflash.flash_attention_cuda.launches == before


@pytest.mark.parametrize("causal", [False, True])
def test_flash_rows_that_see_no_key(causal):
    """With a window, rows i >= T + window - 1 see no key (S 300, T 100,
    window 4). The CUDA wrapper refuses such a call before it looks at the
    device; the plain version keeps matching the reference's oracle there
    (the reference's Pallas kernel, with its 128-key tiles, does not)."""
    q, k, v = flash_inputs(9, 1, 300, 100, 2, 1, 16)
    before = tflash.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="see no key"):
        tflash.flash_attention_cuda(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, window=4)
    assert tflash.flash_attention_cuda.launches == before
    got = tflash.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal, window=4)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal, window=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])
    # one row fewer and every row sees a key: no refusal for that reason
    with pytest.raises(ValueError, match="CUDA tensor"):
        tflash.flash_attention_cuda(
            *map(torch.from_numpy, (q[:, :103], k, v)), causal=causal,
            window=4)


def test_flash_bf16_layout_check():
    """The bf16 kernel copies 16-byte rows: slices of a packed qkv tensor
    pass, a dh-strided view or a start 2 bytes into a row is refused."""
    packed = torch.zeros(2, 30, 10, 40, dtype=torch.bfloat16)
    q, k, v = packed[:, :, :6], packed[:, :, 6:8], packed[:, :, 8:]
    for name, x in (("q", q), ("k", k), ("v", v)):
        tflash._check_bf16_rows("f", name, x)
    wide = torch.zeros(1, 30, 2, 80, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"strides \(\d+, \d+, \d+, 2\)"):
        tflash._check_bf16_rows("f", "q", wide[..., ::2])
    with pytest.raises(ValueError, match="start at byte 2 of 16"):
        tflash._check_bf16_rows("f", "q", wide[..., 1:41])
    # a size-1 dim's stride never moves a row, so it is not held to 8
    tflash._check_bf16_rows("f", "q", wide[:, :1, :1, :40].as_strided(
        (1, 1, 1, 40), (3, 5, 7, 1)))
