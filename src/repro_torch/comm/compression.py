"""Embedding-exchange compression for the §3.1 aggregation boundary.

Counterpart of ``repro.comm.compression``. A ``Compressor`` encodes a
float32 embedding block into its wire representation (the tensors that
would cross the network), decodes it back to the float32 the receiver works
with, and prices one message exactly (``wire_bytes``), so the analytic byte
meter stays term-by-term auditable.

Codecs (same wire formats and prices as the reference):

  * ``none`` / ``identity`` — ``make_compressor`` returns ``None`` and the
    callers take the uncompressed code path verbatim;
  * ``int8`` — per-row absmax: int8 codes from ``torch.round`` (half to
    even, like ``jnp.round``) plus one float32 scale a row, ``d + 4`` bytes
    per ``4d``-byte row; an all-zero row gets a unit scale;
  * ``fp8`` — clipped into ``float8_e4m3fn``'s finite range, then cast
    (e4m3fn has no inf: an unclipped overflow is NaN);
  * ``topk_ef`` — the k largest-|x| entries a row as (float16 value,
    int16 column) pairs, int32 columns past 32768; with ``k >= d`` the dense
    float32 row. Among equal magnitudes the lower column wins, as in
    ``jax.lax.top_k``: a stable descending sort picks the columns on both
    devices (``torch.topk`` on CUDA breaks such ties otherwise, and
    f16-rounded blocks tie often once aggregated).

Error feedback (EF): the sender keeps ``ef_decay * (x_in - decode(encode(
x_in)))`` and adds it to its next upload (``roundtrip_with_ef``). The round
engine keys the accumulators by slot (row position of the fixed-shape
sampled batch), as the reference does (``core.glasu.init_comp_state``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

COMPRESSION_METHODS = ("none", "identity", "int8", "fp8", "topk_ef")

# methods whose uplink keeps an error-feedback accumulator by default
_EF_DEFAULT = {"none": False, "identity": False, "int8": False, "fp8": False,
               "topk_ef": True}


@dataclass(frozen=True)
class CompressionConfig:
    """``method`` picks the codec; ``k`` is the per-row budget of
    ``topk_ef`` (required there, forbidden elsewhere); ``error_feedback``
    toggles the residual accumulators (default: on for ``topk_ef`` only);
    ``ef_decay`` scales the carried residual. Same fields and checks as the
    reference."""

    method: str = "none"
    k: Optional[int] = None
    error_feedback: Optional[bool] = None
    ef_decay: float = 0.5

    def __post_init__(self):
        if self.method not in COMPRESSION_METHODS:
            raise ValueError(
                f"unknown compression method {self.method!r}; expected one "
                f"of {COMPRESSION_METHODS}")
        if self.method == "topk_ef":
            if self.k is None or self.k < 1:
                raise ValueError(
                    "compression method 'topk_ef' requires k >= 1 "
                    f"(got k={self.k})")
        elif self.k is not None:
            raise ValueError(
                f"compression k={self.k} is only meaningful for method "
                f"'topk_ef' (got method {self.method!r})")
        if not 0.0 <= self.ef_decay <= 1.0:
            raise ValueError(
                f"ef_decay must be in [0, 1], got {self.ef_decay}")

    @property
    def resolved_error_feedback(self) -> bool:
        if self.error_feedback is not None:
            return bool(self.error_feedback)
        return _EF_DEFAULT[self.method]

    @property
    def active(self) -> bool:
        return self.method not in ("none", "identity")


Payload = Dict[str, torch.Tensor]


class Compressor:
    """Wire codec: ``encode`` maps ``(..., d)`` float32 to a dict of
    wire-dtype tensors, ``decode`` maps it back row by row, and
    ``wire_bytes(n, d)`` is the byte size of one ``(n, d)`` message's
    payload, exactly."""

    method: str = "abstract"
    error_feedback: bool = False
    ef_decay: float = 0.5

    def encode(self, x: torch.Tensor) -> Payload:
        raise NotImplementedError

    def decode(self, payload: Payload, d: int) -> torch.Tensor:
        raise NotImplementedError

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        """What the receiver reconstructs from ``x``'s wire message."""
        return self.decode(self.encode(x), x.shape[-1])

    def wire_bytes(self, n_rows: int, d: int) -> int:
        raise NotImplementedError


class Int8Quantizer(Compressor):
    """Per-row absmax int8: codes in [-127, 127] + one f32 scale per row."""

    method = "int8"

    def encode(self, x):
        absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
        # all-zero rows: a unit scale encodes (and decodes) them as zeros
        scale = torch.where(absmax > 0.0, absmax / 127.0,
                            torch.ones_like(absmax))
        q = torch.clamp(torch.round(x / scale), -127.0, 127.0)
        return {"q": q.to(torch.int8), "scale": scale.float()}

    def decode(self, payload, d):
        return payload["q"].float() * payload["scale"]

    def wire_bytes(self, n_rows, d):
        return n_rows * d + n_rows * 4


class FloatQuantizer(Compressor):
    """Direct cast to a narrow float format (fp8 e4m3fn by default), after
    clipping into its finite range. 1 byte an element for fp8."""

    method = "fp8"

    def __init__(self, dtype=torch.float8_e4m3fn):
        self.dtype = dtype
        self._max = float(torch.finfo(dtype).max)
        self._itemsize = torch.empty((), dtype=dtype).element_size()

    def encode(self, x):
        return {"q": torch.clamp(x, -self._max, self._max).to(self.dtype)}

    def decode(self, payload, d):
        return payload["q"].float()

    def wire_bytes(self, n_rows, d):
        return n_rows * d * self._itemsize


class TopKCompressor(Compressor):
    """Top-k magnitude sparsification: (f16 value, i16 column) pairs; the
    dense float32 row when ``k >= d`` (4d bytes beat 6d of pairs)."""

    method = "topk_ef"
    error_feedback = True
    # f16 values are clipped into the finite range (the clipped-off
    # magnitude lands in the EF residual); i16 holds columns < 32768
    _F16_MAX = 65504.0
    _I16_COLS = 2 ** 15

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"top-k needs k >= 1, got {k}")
        self.k = int(k)

    def encode(self, x):
        d = x.shape[-1]
        if self.k >= d:
            return {"dense": x}
        idx = torch.sort(torch.abs(x), dim=-1, descending=True,
                         stable=True).indices[..., :self.k]
        vals = torch.gather(x, -1, idx)
        vals = torch.clamp(vals, -self._F16_MAX, self._F16_MAX)
        idx_dtype = torch.int16 if d <= self._I16_COLS else torch.int32
        return {"v": vals.to(torch.float16), "i": idx.to(idx_dtype)}

    def decode(self, payload, d):
        if "dense" in payload:
            return payload["dense"]
        v, i = payload["v"].float(), payload["i"].long()
        lead = v.shape[:-1]
        flat_v, flat_i = v.reshape(-1, self.k), i.reshape(-1, self.k)
        out = torch.zeros(flat_v.shape[0], d, dtype=torch.float32,
                          device=v.device)
        out.scatter_(1, flat_i, flat_v)
        return out.reshape(lead + (d,))

    def wire_bytes(self, n_rows, d):
        if self.k >= d:
            return n_rows * d * 4
        idx_bytes = 2 if d <= self._I16_COLS else 4
        return n_rows * self.k * (2 + idx_bytes)


def make_compressor(cfg: Optional[CompressionConfig]) -> Optional[Compressor]:
    """The codec of a compression block; ``None`` (take the uncompressed
    code path) for no block, ``none`` and ``identity``."""
    if cfg is None or not cfg.active:
        return None
    if cfg.method == "int8":
        comp: Compressor = Int8Quantizer()
    elif cfg.method == "fp8":
        comp = FloatQuantizer()
    elif cfg.method == "topk_ef":
        comp = TopKCompressor(cfg.k)
    else:  # pragma: no cover — CompressionConfig already validated
        raise ValueError(f"unknown compression method {cfg.method!r}")
    comp.error_feedback = cfg.resolved_error_feedback
    comp.ef_decay = cfg.ef_decay
    return comp


def roundtrip_with_ef(comp: Compressor, x: torch.Tensor,
                      ef: Optional[torch.Tensor]
                      ) -> Tuple[Payload, torch.Tensor, Optional[torch.Tensor]]:
    """Compress ``x`` (plus the carried residual) through the wire:
    ``(payload, x_hat, new_ef)`` — the message, what the receiver
    reconstructs, and the sender's residual scaled by ``comp.ef_decay``
    (``None`` in iff ``None`` out)."""
    x_in = x if ef is None else x + ef
    payload = comp.encode(x_in)
    x_hat = comp.decode(payload, x.shape[-1])
    new_ef = None if ef is None else comp.ef_decay * (x_in - x_hat)
    return payload, x_hat, new_ef

