"""Placement rules: the production mesh's parameter, optimizer-state, batch
and cache specs, and the client-stacked rules of the sharded GLASU backend.

Counterpart of ``repro.launch.sharding``.

**Production rules** (``param_specs``, ``opt_state_specs``, ``batch_spec``,
``batch_shardings``, ``cache_specs``, ``tree_shardings``): the reference's
logic, rule for rule. Parameter specs come from leaf *names*, with
structural overrides for expert-stacked and client-stacked weights; large
weights also shard a free dim over ``data`` (``_add_fsdp``); every rule is
divisibility-guarded (an axis that is absent or does not divide the dim
falls back to replication). A spec is a ``P``: one entry per tensor dim, a
mesh axis name, a tuple of names or ``None``. ``placements`` turns it into
DTensor placements over a ``torch.distributed`` ``DeviceMesh`` (one entry
per *mesh* dim: ``Shard(tensor dim)`` or ``Replicate()``), and
``distribute`` places a tree by its shardings.

**Client rules** (``client_leaf_spec`` ... ``gather_block``): the federated
split model stacks the M clients on the leading axis of every parameter,
optimizer-state, batch and carry tensor; a ``ClientSpec`` says which axis a
leaf holds its clients on (``None``: replicated). ``local_block`` takes a
rank's even block of a global tree (``x[i0:i0+m_loc]``, or
``x[:, i0:i0+m_loc]`` for round-stacked batches) and ``gather_block``
reassembles a tree of blocks with all-gathers along the client axis. As in
the reference every rule is divisibility-guarded: a leaf whose client axis
does not split into the mesh's blocks stays replicated (the client mesh is
built so that M always does).
"""
from __future__ import annotations

from dataclasses import dataclass
from math import prod
from typing import Optional

import torch

from ..configs.base import ArchConfig, InputShape
from ..optim.optimizers import AdafactorState, AdamState, SGDState
from ..tree import tree_leaves, tree_map, tree_unflatten
from .mesh import ClientMesh


# ------------------------------------------------------------ production mesh
class P:
    """A partition spec: for each tensor dim, the mesh axis it is split
    over (a name), the axes in order (a tuple of names), or ``None``
    (whole). A tree leaf, unlike a tuple; ``tuple(spec)`` gives the
    entries, as ``tuple(jax.sharding.PartitionSpec(...))`` does (a tuple
    of one name becomes the name, as there)."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                             else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` built with dim names."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: mesh dim ``i`` is
    ``Shard(d)`` when tensor dim ``d`` is split over its axis, else
    ``Replicate()`` (also for an axis of size 1, which splits nothing). A
    dim split over several axes (("pod", "data")) is sharded on each of
    their mesh dims, major to minor in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of and n > 1 else Replicate()
                 for a, n in zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


# leaf name -> spec for the TRAILING dims (left-padded with None)
_NAME_RULES = {
    "emb": ("model", None),
    "unemb": (None, "model"),
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "wg": (None, "model"), "wr": (None, "model"),
    "wo": ("model", None),
    "w_gate": (None, "model"), "w_up": (None, "model"),
    "w_down": ("model", None),
    "w_uk": (None, "model"), "w_uv": (None, "model"),
    "w_dkv": (), "w_kr": (), "router": (),
    "w_in": (None, "model"), "w_out": ("model", None),
    "conv_w": (None, "model"), "conv_b": ("model",),
    "A_log": ("model",), "D": ("model",), "dt_bias": ("model",),
    "w_A": (), "w_B": (None, "model"),
    "u": ("model", None),
    "mix": (), "w_base": ("model",),
    "g": (), "b": (),
    "b_up": ("model",), "b_down": (),
}


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        return prod(_axis_size(mesh, n) for n in name)
    return axis_sizes(mesh).get(name, 0)


def _guard(mesh, shape, spec) -> P:
    """Replace axis names that don't exist or don't divide the dim."""
    out = []
    for dim, s in zip(shape, spec):
        size = _axis_size(mesh, s)
        out.append(s if size and dim % size == 0 and size > 1 else None)
    return P(*out)


def _leaf_spec(path, leaf, mesh) -> P:
    keys = list(path)
    name = keys[-1]
    in_moe = "moe" in keys and "shared" not in keys
    in_locals = "locals" in keys
    nd = leaf.ndim
    if in_locals:
        # (n_groups, sync_every-1, M, ...) — shard the client axis
        spec = [None] * nd
        if nd >= 3:
            spec[2] = "model"
        return _guard(mesh, leaf.shape, spec)
    if in_moe and name in ("w_gate", "w_up", "w_down") and nd >= 3:
        # (..., E, d, f) — expert parallel
        spec = [None] * nd
        spec[nd - 3] = "model"
        return _guard(mesh, leaf.shape, spec)
    rule = _NAME_RULES.get(name, ())
    spec = [None] * (nd - len(rule)) + list(rule)
    spec = spec[:nd]
    spec = _add_fsdp(mesh, leaf, spec)
    return _guard(mesh, leaf.shape, spec)


_FSDP_MIN_BYTES = 16 * 2**20


def _add_fsdp(mesh, leaf, spec):
    """ZeRO-3-style: large weights additionally shard a free dim over
    'data' (each use all-gathers them). Without this, llama3-405b weights
    are 50 GB a device at TP=16."""
    if "data" not in mesh.mesh_dim_names:
        return spec
    nbytes = leaf.numel() * leaf.element_size()
    if nbytes < _FSDP_MIN_BYTES or leaf.ndim < 2:
        return spec
    dp = axis_sizes(mesh)["data"]
    # pick the largest unsharded trailing dim divisible by the data axis
    best, best_dim = None, 0
    for i in range(leaf.ndim - 1, 0, -1):
        if spec[i] is None and leaf.shape[i] % dp == 0 \
                and leaf.shape[i] > best_dim:
            best, best_dim = i, leaf.shape[i]
    if best is not None:
        spec = list(spec)
        spec[best] = "data"
    return spec


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over every leaf; ``path`` holds the dict keys,
    NamedTuple field names and sequence indices down to the leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        keys = getattr(tree, "_fields", range(len(tree)))
        kids = [tree_map_with_path(fn, v, path + (k,))
                for k, v in zip(keys, tree)]
        return type(tree)(*kids) if hasattr(tree, "_fields") \
            else type(tree)(kids)
    return fn(path, tree)


def param_specs(params, mesh):
    return tree_map_with_path(
        lambda path, leaf: _leaf_spec(path, leaf, mesh), params)


def opt_state_specs(opt_state, pspecs, mesh):
    """Optimizer-state specs derived structurally from the param specs.
    The step counter (a Python int here) is the scalar ``P()``."""
    scalar = P()
    if isinstance(opt_state, AdamState):
        return AdamState(scalar, pspecs, pspecs)
    if isinstance(opt_state, SGDState):
        mom = pspecs if opt_state.momentum is not None else None
        return SGDState(scalar, mom)
    if isinstance(opt_state, AdafactorState):
        def fit(leaf, s):
            """Trim/align the param spec to the factored leaf's rank."""
            if leaf.ndim == 0:
                return P()
            t = (list(s) + [None] * leaf.ndim)[:leaf.ndim]
            return P(*t)

        def map2(fn, tree):
            return tree_unflatten(tree, [
                fn(le, s) for le, s in zip(tree_leaves(tree),
                                           tree_leaves(pspecs))])

        vr = map2(lambda le, s: fit(le, list(s)[:-1] if len(s) else []),
                  opt_state.vr)
        vc = map2(lambda le, s: fit(le, (list(s)[:-2] + list(s)[-1:])
                                    if len(s) >= 2 else list(s)),
                  opt_state.vc)
        v = map2(lambda le, s: fit(le, list(s)), opt_state.v)
        return AdafactorState(scalar, vr, vc, v)
    raise ValueError(f"unknown optimizer state {type(opt_state)}")


def batch_spec(cfg: ArchConfig, shape: InputShape, mesh, name: str,
               arr_shape) -> P:
    """Batch dim over (pod, data) where it divides; the rest whole (the
    (B, T, D) embeddings' feature dim too: full-width layers take it)."""
    pod = "pod" in mesh.mesh_dim_names
    dp = _axis_size(mesh, ("pod", "data") if pod else ("data",))
    dp_axes = ("pod", "data") if pod else "data"
    first = dp_axes if arr_shape[0] % dp == 0 and dp > 1 else None
    return P(first, *[None] * (len(arr_shape) - 1))


def batch_shardings(cfg: ArchConfig, shape: InputShape, specs_or_batch,
                    mesh):
    return {k: NamedSharding(mesh, batch_spec(cfg, shape, mesh, k, v.shape))
            for k, v in specs_or_batch.items()}


def cache_specs(cfg: ArchConfig, shape: InputShape, caches, mesh):
    """Decode-cache specs.

    Leaves are (L, B, C, heads, dh)-ish stacks. Policy: shard batch over
    (pod, data) when divisible; otherwise (long_500k, B=1) shard the cache
    *sequence* dim over 'data'. Head/state axes shard over 'model' when
    divisible. Integer leaves (the positions) stay whole."""
    dp_axes = ("pod", "data") if "pod" in mesh.mesh_dim_names \
        else ("data",)
    dp = _axis_size(mesh, dp_axes)
    batch = shape.global_batch
    batch_ok = batch % dp == 0 and dp > 1
    tp = _axis_size(mesh, "model")

    def leaf_rule(leaf):
        nd = leaf.ndim
        if nd == 0 or not leaf.dtype.is_floating_point:
            return P()
        spec = [None] * nd
        # dim 0 is the layer stack; dim 1 is batch (for stacked caches)
        if nd >= 2:
            if batch_ok and leaf.shape[1] == batch:
                spec[1] = dp_axes
            elif not batch_ok and nd >= 3 and leaf.shape[2] >= dp:
                # shard sequence dim over data (flash-decode style)
                if leaf.shape[2] % dp == 0:
                    spec[2] = dp_axes
        # shard a head-like axis over model: prefer dim -2 for (…, H, dh)
        for cand in (nd - 2, nd - 1):
            if cand >= 2 and spec[cand] is None:
                if leaf.shape[cand] % tp == 0 and leaf.shape[cand] >= tp > 1:
                    spec[cand] = "model"
                    break
        return P(*spec)

    return tree_map(leaf_rule, caches)


def tree_shardings(tree_specs, mesh):
    return tree_map(lambda s: NamedSharding(mesh, s), tree_specs)


def local_shard(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``sharding`` (a view):
    tensor dim d split over mesh dims m1, m2, ... (in mesh order) takes
    block ``c[m1] * n[m2] + c[m2]`` ... of ``prod(n)`` even blocks, as
    DTensor's ``Shard`` lays them out."""
    mesh, place = sharding.mesh, sharding.placements
    coord = mesh.get_coordinate()
    for d in range(x.ndim):
        idx, n = 0, 1
        for m, pl in enumerate(place):
            if pl.is_shard(d):
                idx, n = idx * mesh.size(m) + coord[m], n * mesh.size(m)
        if n > 1:
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"split into {n} even blocks")
            size = x.shape[d] // n
            x = x.narrow(d, idx * size, size)
    return x


def distribute(tree, shardings):
    """Every tensor leaf of ``tree`` as a DTensor placed by the matching
    ``NamedSharding`` of ``shardings`` (same structure): this rank keeps
    its block, and placing moves nothing (the reference's ``in_shardings``
    at the jit boundary). A leaf that is not a tensor (an int step
    counter) is kept as it is."""
    from torch.distributed.tensor import DTensor

    def place(x, s):
        if not isinstance(x, torch.Tensor):
            return x
        return DTensor.from_local(local_shard(x, s).contiguous(), s.mesh,
                                  s.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())
    return tree_unflatten(tree, [place(x, s) for x, s in
                                 zip(tree_leaves(tree),
                                     tree_leaves(shardings))])


# --------------------------------------------------- GLASU client-stacked path


@dataclass(frozen=True)
class ClientSpec:
    """The axis a leaf stacks its clients on; ``None``: replicated."""
    dim: Optional[int] = None


REPLICATED = ClientSpec()


def client_leaf_spec(leaf, mesh: ClientMesh, lead: int = 0) -> ClientSpec:
    """Shard axis ``lead`` (the client-stacked axis) over the mesh,
    guarded: anything that is not a tensor with that axis divisible into
    ``mesh.size`` blocks stays replicated."""
    if isinstance(leaf, torch.Tensor) and leaf.ndim > lead \
            and leaf.shape[lead] % mesh.size == 0:
        return ClientSpec(lead)
    return REPLICATED


def client_param_specs(params, mesh: ClientMesh):
    """Specs of a client-stacked tree (every tensor leaf (M, ...)): the
    parameters, and the optimizer states whose moments mirror them (the
    step counter, an int, stays replicated)."""
    return tree_map(lambda l: client_leaf_spec(l, mesh), params)


def client_batch_specs(batch, mesh: ClientMesh, round_stacked: bool = False):
    """Specs of a ``SampledBatch``: client-stacked leaves shard their client
    axis (0, or 1 under a leading round axis); ``labels`` is the shared
    mini-batch (replicated, paper Alg 2)."""
    lead = 1 if round_stacked else 0
    leaf = lambda x: client_leaf_spec(x, mesh, lead)
    per = lambda xs: tuple(leaf(x) for x in xs)
    return type(batch)(
        feats=leaf(batch.feats), gather_idx=per(batch.gather_idx),
        gather_mask=per(batch.gather_mask), row_valid=per(batch.row_valid),
        labels=REPLICATED, self_pos=per(batch.self_pos))


def client_comp_state_specs(comp_state, mesh: ClientMesh):
    """Specs of the error-feedback carry (``core.glasu.init_comp_state``):
    the uplink accumulator is client-stacked, the downlink one is server
    state (replicated)."""
    return {l: {"up": client_leaf_spec(st["up"], mesh), "down": REPLICATED}
            for l, st in comp_state.items()}


def client_fault_state_specs(fault_state, mesh: ClientMesh,
                             replicated: bool = False):
    """Specs of the stale-embedding cache (``core.glasu.init_fault_state``):
    each per-layer stack shards its clients. ``replicated=True`` (composed
    with compression): the cache holds the server's DECODED view, which
    every rank recomputes from the gathered payload, so it stays whole."""
    if replicated:
        return {l: REPLICATED for l in fault_state}
    return {l: client_leaf_spec(c, mesh) for l, c in fault_state.items()}


def local_inputs(params, batch, mesh: ClientMesh):
    """The rank's block of a client-stacked parameter tree and of one
    round's ``SampledBatch``: the inputs of a forward with ``mesh=``."""
    return (local_block(params, client_param_specs(params, mesh), mesh),
            local_block(batch, client_batch_specs(batch, mesh), mesh))


def local_block(tree, specs, mesh: ClientMesh):
    """The rank's block of every sharded leaf of ``tree`` (views);
    replicated leaves as they are."""
    def take(x, spec):
        if spec.dim is None:
            return x
        n = x.shape[spec.dim] // mesh.size
        return x.narrow(spec.dim, mesh.rank * n, n)
    return tree_unflatten(tree, [take(x, s) for x, s in
                                 zip(tree_leaves(tree), tree_leaves(specs))])


def gather_block(tree, specs, mesh: ClientMesh):
    """Reassemble a tree of rank blocks into global leaves: the sharded
    leaves of one dtype travel as ONE all-gather of their flattened blocks
    (in tree order), replicated leaves are kept as they are."""
    leaves, spec_leaves = tree_leaves(tree), tree_leaves(specs)
    out = list(leaves)
    groups = {}
    for i, (x, s) in enumerate(zip(leaves, spec_leaves)):
        if s.dim is not None:
            groups.setdefault(x.dtype, []).append(i)
    for idx in groups.values():
        blocks = [leaves[i].movedim(spec_leaves[i].dim, 0) for i in idx]
        m_loc = blocks[0].shape[0]
        flat = torch.cat([b.reshape(m_loc, -1) for b in blocks], dim=1)
        full = mesh.gather(flat)
        col = 0
        for i, b in zip(idx, blocks):
            width = b[0].numel()
            piece = full[:, col:col + width].reshape(
                (full.shape[0],) + b.shape[1:])
            out[i] = piece.movedim(0, spec_leaves[i].dim).contiguous()
            col += width
    return tree_unflatten(tree, out)
