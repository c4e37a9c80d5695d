"""Per-device cost of one eager call, op by op: the counterpart of
``repro.launch.hlo_cost``.

The reference walks XLA's optimized HLO with loop trip counts; here the
call runs (eagerly, so every loop iteration runs and is counted) under
``CostCounter``, a ``TorchDispatchMode`` that sees each ATen op on the
tensors this rank holds. On a DTensor it steps aside (returns
``NotImplemented``) so that DTensor dispatches first and the counter sees
the local ops and the collectives DTensor issues, with local shapes. The
ops DTensor runs on ``FakeTensor``s to propagate global shapes are not
counted. It accumulates:

  * flops            — 2·M·N·K for the matmul family (``mm``, ``bmm``,
                       ``addmm``, ``baddbmm``, ``mv``, ``dot``) and
                       convolutions; the reference counts dots and
                       convolutions only, so no elementwise work either;
  * hbm_bytes        — operand + result bytes of every op that is not a
                       view: the eager program's traffic, each op reading
                       and writing memory. XLA charges fusion boundaries
                       instead, so this number is NOT the reference's and
                       is not held to it;
  * collectives      — per ``_c10d_functional`` collective kind, its count
                       and result bytes (all-reduce ×2, as the reference
                       counts it); ``by_group`` the same per process group
                       (a mesh axis);
  * peak live bytes  — the most bytes of tensor storage alive at once
                       during the call (storages registered with ``track``
                       beforehand, and every storage an op creates until
                       it is freed).

``measure(fn, *args, **kw)`` returns the keys of ``hlo_cost.analyze``:
``flops``, ``hbm_bytes``, ``collectives`` (``{kind: {count, bytes}}``,
kinds seen only), ``collective_bytes`` and ``entry`` (the function's
name).
"""
from __future__ import annotations

import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

_MATMUL = {aten.mm.default, aten.bmm.default, aten.addmm.default,
           aten.baddbmm.default, aten.mv.default, aten.dot.default}
_CONV = {aten.convolution.default}

# _c10d_functional op name (prefix) -> the reference's collective kind
_COLLECTIVE_KINDS = (("all_gather", "all-gather"),
                     ("all_reduce", "all-reduce"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_to_all", "all-to-all"),
                     ("permute", "collective-permute"))


def _tensors(tree, out=None):
    """The tensors in an op's (nested list / tuple / dict) arguments or
    results."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _tensors(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _tensors(t, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(func, args, out) -> float:
    """2 · (output elements) · (contracted size)."""
    if func is aten.addmm.default or func is aten.baddbmm.default:
        a = args[1]
    else:
        a = args[0]
    return 2.0 * out.numel() * a.shape[-1]


def _conv_flops(args, out) -> float:
    """2 · (output elements) · (Cin / groups) · (kernel elements)."""
    w = args[1]
    return 2.0 * out.numel() * math.prod(w.shape[1:])


def _collective_kind(func):
    """The reference's name for a ``_c10d_functional`` op's collective, or
    None (``wait_tensor`` and the like)."""
    for prefix, kind in _COLLECTIVE_KINDS:
        if func._opname.startswith(prefix):
            return kind
    return None


class CostCounter(TorchDispatchMode):
    """Counts the ops run under it (see the module docstring). ``track``
    registers tensors that exist before the call (its arguments) as live
    storage; ``peak_bytes`` is the most live storage seen."""

    def __init__(self):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        self._fake = FakeTensor
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives = {}
        self.by_group = {}        # process group name -> collectives
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live = {}           # id(storage) -> weakref (holds the size)

    # ------------------------------------------------------------ storage
    def _add_storage(self, t: torch.Tensor) -> None:
        if isinstance(t, self._fake) or t.layout != torch.strided:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        size = st.nbytes()

        def freed(_, key=key, size=size, live=self._live, me=self):
            if live.pop(key, None) is not None:
                me.live_bytes -= size

        self._live[key] = weakref.ref(st, freed)
        self.live_bytes += size
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def track(self, tree) -> int:
        """Register the local tensors of ``tree`` (DTensors by their
        local shards) as live; returns their bytes."""
        n = 0
        for t in _tensors(tree):
            t = _local(t)
            before = self.live_bytes
            self._add_storage(t)
            n += self.live_bytes - before
        return n

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented          # DTensor first: see its local ops
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if any(isinstance(t, self._fake) for t in ins + outs):
            return out                     # DTensor's shape propagation
        if func.namespace == "_c10d_functional":
            kind = _collective_kind(func)
            if kind is None:
                return out                 # wait_tensor and the like
        else:
            kind = None
        if kind is not None:
            b = sum(_nbytes(t) for t in outs)
            b = 2 * b if kind == "all-reduce" else b
            group = kwargs.get("group_name", args[-1])
            for rec in (self.collectives.setdefault(kind, {}),
                        self.by_group.setdefault(group, {}).setdefault(
                            kind, {})):
                rec["count"] = rec.get("count", 0) + 1
                rec["bytes"] = rec.get("bytes", 0) + b
            self.hbm_bytes += sum(_nbytes(t) for t in outs)
        elif func in _MATMUL:
            self.flops += _matmul_flops(func, args, outs[0])
        elif func in _CONV:
            self.flops += _conv_flops(args, outs[0])
        if kind is None and not func.is_view and outs:
            self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._add_storage(t)
        return out

    def cost(self, entry: str = "") -> dict:
        """The counts so far, under the keys of ``hlo_cost.analyze``."""
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collectives": {k: dict(v)
                                for k, v in self.collectives.items()},
                "collective_bytes": sum(v["bytes"]
                                        for v in self.collectives.values()),
                "entry": entry}


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def measure(fn, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` once under a ``CostCounter`` and return its
    per-device cost (``flops``, ``hbm_bytes``, ``collectives``,
    ``collective_bytes``, ``entry``)."""
    with CostCounter() as counter:
        fn(*args, **kw)
    return counter.cost(getattr(fn, "__qualname__", repr(fn)))
