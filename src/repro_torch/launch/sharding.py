"""Client-stacked placement rules of the sharded GLASU backend.

Counterpart of the GLASU client rules of ``repro.launch.sharding``
(``client_leaf_spec``, ``client_param_specs``, ``client_batch_specs``,
``client_comp_state_specs``, ``client_fault_state_specs``). The federated
split model stacks the M clients on the leading axis of every parameter,
optimizer-state, batch and carry tensor; a ``ClientSpec`` says which axis a
leaf holds its clients on (``None``: replicated). ``local_block`` takes a
rank's even block of a global tree (``x[i0:i0+m_loc]``, or
``x[:, i0:i0+m_loc]`` for round-stacked batches) and ``gather_block``
reassembles a tree of blocks with all-gathers along the client axis.

As in the reference every rule is divisibility-guarded: a leaf whose client
axis does not split into the mesh's blocks stays replicated (the client
mesh is built so that M always does).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten
from .mesh import ClientMesh


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
