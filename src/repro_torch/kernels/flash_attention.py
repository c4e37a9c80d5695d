"""Hopper flash-attention kernel with its plain version.

Counterpart of ``repro.kernels.flash_attention``: online-softmax attention,
causal, sliding-window or bidirectional, with native GQA (kv head = q head
// (H / Kv)). q: (B, S, H, dh); k/v: (B, T, Kv, dh) -> (B, S, H, dh) in q's
dtype, fp32 math inside.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` and accepts
only what that kernel reads correctly: fp32 or bf16 CUDA tensors of one
dtype and device, dh a multiple of 8 up to 128, every query row seeing at
least one key. bf16 runs on the tensor cores and reads rows with cp.async,
so it also needs unit stride on dh and 16-byte aligned rows (see
``_check_bf16_rows``); fp32 runs on the CUDA cores through any strides. It
raises on anything else and on a failed launch; it never falls back to the
plain version and never copies an input. ``flash_attention_cuda.launches``
counts its launches, so a run can show that a path went through the kernel.

``flash_attention_plain`` repeats the kernel's arithmetic in plain PyTorch
(q cast to fp32 and scaled before the dot, the finite NEG_INF on masked
scores, the row sum clamped at 1e-30), with an exact softmax over every key
instead of the running one, taken over query chunks of ``PLAIN_Q_CHUNK`` rows
so that its scores stay a few GB at a 32k context.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build

NEG_INF = -1e30          # the reference's finite mask value
PLAIN_Q_CHUNK = 1024     # query rows of one plain-version score block
MAX_HEAD_DIM = 128


def _visible(q0, q1, t, causal, window, device):
    """(q1 - q0, t) bool: key j is visible from query row i."""
    qpos = torch.arange(q0, q1, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((q1 - q0, t), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None):
    """Plain PyTorch attention with the kernel's arithmetic; see the module
    docstring. Differentiable; the CPU tests and ``ops.flash_attention`` on
    a CPU tensor use it."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / (dh ** 0.5)
    kf, vf = k.float(), v.float()
    chunks = []
    for q0 in range(0, s, PLAIN_Q_CHUNK):
        q1 = min(q0 + PLAIN_Q_CHUNK, s)
        qg = (q[:, q0:q1].float() * scale).reshape(b, q1 - q0, kv, g, dh)
        sc = torch.einsum("bskgd,btkd->bkgst", qg, kf)
        sc = torch.where(_visible(q0, q1, t, causal, window, q.device), sc,
                         torch.full_like(sc, NEG_INF))
        p = torch.exp(sc - torch.amax(sc, dim=-1, keepdim=True))
        denom = torch.clamp(torch.sum(p, dim=-1), min=1e-30)  # (b,kv,g,s)
        o = torch.einsum("bkgst,btkd->bskgd", p, vf) \
            / denom.permute(0, 3, 1, 2)[..., None]
        chunks.append(o.reshape(b, q1 - q0, h, dh))
    out = torch.cat(chunks, dim=1) if chunks else q.new_zeros(q.shape)
    return out.to(q.dtype)


def _check(fn, name, t, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} is {t.dtype}, expected {dtype}")
    if t.dim() != 4:
        raise ValueError(f"{fn}: {name} must be rank 4, got shape "
                         f"{tuple(t.shape)}")


def _check_bf16_rows(fn, name, t):
    """The bf16 kernel copies each dh-row as 16-byte chunks: unit stride on
    dh, every other stride of an extent above 1 a multiple of 8 elements,
    a 16-byte aligned start."""
    strided = any(n > 1 and st % 8 for n, st in zip(t.shape[:3],
                                                    t.stride()[:3]))
    if t.stride(3) != 1 or strided or t.data_ptr() % 16:
        raise ValueError(
            f"{fn}: bf16 {name} needs unit stride on dh and 16-byte aligned "
            f"rows (strides a multiple of 8); got strides {tuple(t.stride())}"
            f", start at byte {t.data_ptr() % 16} of 16")


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None):
    """Attention on the hand-written Hopper kernel.

    Same contract as ``flash_attention_plain``, forward only: q, k and v
    fp32 or bf16 (all one dtype) on one CUDA device; dh a multiple of 8 up
    to 128 (the wrapper raises above that); window None or a positive int,
    with S < T + window so that every query row sees a key (the kernel and
    the reference's Pallas kernel give such rows different values). fp32 is
    read through any strides, bf16 as ``_check_bf16_rows`` says. The output
    is allocated here, contiguous (B, S, H, dh) in q's dtype, and the
    kernel runs on the current stream.
    """
    fn = "flash_attention_cuda"
    if window is not None and all(isinstance(x, torch.Tensor)
                                  and x.dim() == 4 for x in (q, k)) \
            and q.shape[1] >= k.shape[1] + int(window):
        raise ValueError(
            f"{fn}: query rows {k.shape[1] + int(window) - 1} .. "
            f"{q.shape[1] - 1} see no key (S {q.shape[1]} >= T {k.shape[1]} "
            f"+ window {window}); the plain version is flash_attention_plain")
    if not isinstance(q, torch.Tensor) or q.device.type != "cuda":
        raise ValueError(f"{fn}: q must be a CUDA tensor (the plain version "
                         "is flash_attention_plain)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: q is {q.dtype}; the kernel reads float32 or "
                        "bfloat16")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(fn, name, t, q.dtype, dev)
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, t, kv, dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{fn}: k and v must be (B, T, Kv, dh) = "
                         f"({b}, T, Kv, {dh}); got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if kv == 0 or h % kv:
        raise ValueError(f"{fn}: {h} query heads do not group over {kv} kv "
                         "heads")
    if dh % 8 or not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"{fn}: head dim {dh} is not a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}]")
    if window is not None and int(window) < 1:
        raise ValueError(f"{fn}: window must be None or >= 1, got {window}")
    if h > 65535 or b > 65535:
        raise ValueError(f"{fn}: more than 65535 heads or batch rows")
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            _check_bf16_rows(fn, name, x)
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    if t == 0:
        raise ValueError(f"{fn}: no keys (T = 0)")
    lib = build.load("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, t, h, kv, dh, *q.stride(), *k.stride(), *v.stride(),
        int(causal), 0 if window is None else int(window),
        1.0 / (dh ** 0.5), int(q.dtype == torch.bfloat16),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{fn}: launch failed with cudaError {err} (B={b}, S={s}, T={t}, "
            f"H={h}, Kv={kv}, dh={dh}, {q.dtype}, causal={causal}, "
            f"window={window})")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
