"""Meshes on ``torch.distributed``: the production meshes of the multi-pod
dry-run and the client mesh of the sharded GLASU backend.

Counterpart of ``repro.launch.mesh``.

**Production meshes.** ``make_production_mesh`` is the ``(16, 16)``
``("data", "model")`` mesh of 256 ranks, or ``(2, 16, 16)`` ``("pod",
"data", "model")`` of 512, as a ``DeviceMesh``; ``make_debug_mesh`` a
small ``("data", "model")`` one. Both need a default process group that
large. ``placeholder_group(n)`` makes one in this process without any
peer: torch's ``"fake"`` backend, whose collectives move nothing, with
this process as rank 0 of ``n`` (the reference forces 512 host devices
instead). It refuses to start while a default group exists and destroys
its own on exit, a failure included.

**The client mesh.** The reference's client mesh is a
one-axis ``('clients',)`` device mesh; here it is a process group over
``d`` ranks, one device each, where ``d`` is the largest divisor of the
client count that the world (capped at ``max_devices``) allows. Rank ``r``
holds the even block of ``m_loc = M / d`` clients from global client
``i0 = r * m_loc``; ``ClientMesh.gather`` all-gathers a block along the
client axis, the only cross-rank traffic of a round.

With no default process group, ``make_client_mesh`` builds a one-rank group
in this process from a ``HashStore`` (gloo for CPU tensors, NCCL for CUDA
tensors): one device runs the same collective code with a single shard,
where each gather is a copy. That group belongs to the meshes built on it:
it lives until the last of them is closed (``ClientMesh.close``, which the
sharded backend, the ``Trainer`` and the ``InferenceSession`` call from
their own ``close``), and then the process may initialize a default group
of its own. A multi-rank run initializes the default group itself
(``torch.distributed.init_process_group`` with its own store, world size
and rank) before building the mesh; that group stays the caller's.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from ..device import resolve_device


@contextlib.contextmanager
def placeholder_group(world_size: int):
    """The default process group as ``world_size`` placeholder ranks, this
    process rank 0, for as long as the context lasts: the ``"fake"``
    backend (``torch.testing._internal.distributed.fake_pg``), whose
    collectives complete at once and move nothing. Raises if a default
    group already exists (one this module's ``make_client_mesh`` built, or
    the caller's)."""
    if dist.is_initialized():
        raise RuntimeError(
            "placeholder_group: a default process group already exists "
            f"(backend {dist.get_backend()!r}, world size "
            f"{dist.get_world_size()}); close the meshes, trainers and "
            "sessions that hold it, or destroy it, first")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield dist.group.WORLD
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _device_mesh(shape, axes, device):
    """A ``DeviceMesh`` of ranks ``0 .. prod(shape) - 1`` of the default
    group, laid out row-major over ``axes``, for tensors on ``device``."""
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for d in shape:
        n *= d
    if not dist.is_initialized() or dist.get_world_size() < n:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a default process "
            f"group of at least {n} ranks (placeholder_group({n}))")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh: 16x16 = 256 ranks over ("data", "model"); with
    ``multi_pod`` 2 pods, 2x16x16 = 512 over ("pod", "data", "model").
    ``device`` (default: CUDA) is the type of the tensors placed on it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device or "cuda")


def make_debug_mesh(data: int = 1, model: int = 1, device=None):
    """A small ("data", "model") mesh (tests; a 1x1 one for the dry-run
    against a real step)."""
    return _device_mesh((data, model), ("data", "model"), device or "cuda")


def client_mesh_size(n_clients: int, n_devices: int) -> int:
    """Largest divisor of ``n_clients`` that fits on ``n_devices``: even
    client blocks a rank; with fewer devices than any divisor > 1 the mesh
    is one rank (``m_loc = M``)."""
    if n_clients < 1 or n_devices < 1:
        raise ValueError(f"need positive counts, got n_clients={n_clients} "
                         f"n_devices={n_devices}")
    return max(d for d in range(1, min(n_clients, n_devices) + 1)
               if n_clients % d == 0)


# the one-rank default group built here, and the meshes still open on it
_one_rank = {"group": None, "meshes": 0}


@dataclass
class ClientMesh:
    """A rank's place in the client mesh: ``size`` ranks, this one's
    ``rank``, its ``m_loc`` clients from global client ``i0``, the process
    ``group`` over the ``size`` ranks and the ``device`` its blocks live
    on. ``owns_group``: the mesh is one of the users of the one-rank group
    ``make_client_mesh`` built, until ``close``."""
    size: int
    rank: int
    m_loc: int
    group: Any
    device: torch.device
    owns_group: bool = False

    @property
    def i0(self) -> int:
        return self.rank * self.m_loc

    @property
    def n_clients(self) -> int:
        return self.size * self.m_loc

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """All-gather each rank's block ``x`` (leading dim ``m_loc``) into
        the global stack (leading dim M), in rank order. Tensors of a dtype
        the backend may not carry (int16, fp8) travel as their bytes."""
        x = x.contiguous()
        wire = x if x.dtype in (torch.float32, torch.int32, torch.int64,
                                torch.uint8) else x.view(torch.uint8)
        out = torch.empty((self.size * wire.shape[0],) + wire.shape[1:],
                          dtype=wire.dtype, device=wire.device)
        dist.all_gather_into_tensor(out, wire, group=self.group)
        return out if wire is x else out.view(x.dtype)

    def close(self) -> None:
        """Release the mesh: the last open mesh on the one-rank group that
        ``make_client_mesh`` built destroys that group. A group the caller
        initialized is left alone. Closing twice is a no-op."""
        if not self.owns_group:
            return
        self.owns_group = False
        _one_rank["meshes"] -= 1
        if _one_rank["meshes"] == 0:
            if dist.is_initialized() and \
                    dist.group.WORLD is _one_rank["group"]:
                dist.destroy_process_group()
            _one_rank["group"] = None


def _one_rank_group() -> None:
    """The default group as one in-process rank (no rendezvous, no port)."""
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_client_mesh(n_clients: int, *, max_devices=None,
                     device=None) -> ClientMesh:
    """The client mesh of this rank: ``d = client_mesh_size(n_clients,
    min(world_size, max_devices))`` ranks of the default group. When none
    exists, a one-rank default group is built in-process and the mesh
    shares it with the other meshes built on it: close every mesh (or what
    holds it) to destroy that group again. On CUDA a rank uses its current
    device (a multi-rank run calls ``torch.cuda.set_device`` first). Every
    rank of the world must call this (a subgroup is a collective); a rank
    outside the first ``d`` raises."""
    if max_devices is not None and max_devices < 1:
        raise ValueError(f"max_devices must be >= 1, got {max_devices}")
    dev = resolve_device(device)
    if not dist.is_initialized():
        _one_rank_group()
        _one_rank.update(group=dist.group.WORLD, meshes=0)
    owns = _one_rank["group"] is not None and \
        dist.group.WORLD is _one_rank["group"]
    world, rank = dist.get_world_size(), dist.get_rank()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    d = client_mesh_size(n_clients, min(world, max_devices or world))
    group = dist.group.WORLD if d == world else dist.new_group(list(range(d)))
    if rank >= d:
        raise ValueError(
            f"rank {rank} is outside the client mesh: {n_clients} clients "
            f"take {d} of the {world} ranks (the largest dividing count); "
            "launch that many ranks or pass max_devices")
    _one_rank["meshes"] += owns
    return ClientMesh(size=d, rank=rank, m_loc=n_clients // d, group=group,
                      device=dev, owns_group=owns)
