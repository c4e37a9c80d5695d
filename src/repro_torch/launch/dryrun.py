"""Multi-pod dry-run: trace every (architecture x input shape) on the
production meshes, print the per-device memory and cost, and record the
collective schedule for the roofline analysis.

Counterpart of ``repro.launch.dryrun``. The reference lowers and compiles
each step with GSPMD over 256 / 512 forced host devices; here:

  * the mesh is a ``DeviceMesh`` over a placeholder default group
    (``launch.mesh.placeholder_group``: torch's ``"fake"`` backend, this
    process rank 0 of 256 or 512, collectives that move nothing);
  * the state is built for shapes only (``jax.eval_shape``'s part): the
    init functions run under ``FakeTensorMode`` and the result becomes
    storage-less ``meta`` tensors, so nothing is allocated, even for
    llama3-405b;
  * the inputs are placed by ``launch.sharding``'s specs as DTensors, each
    rank's block on it (the reference's ``in_shardings``);
  * "lower + compile" is one traced execution of the step under
    ``activation_mesh`` (the model's ``shard`` calls redistribute, where
    GSPMD takes its constraints) and ``implicit_replication`` (a plain
    tensor made inside the step, a mask or a position, is the same on
    every rank); the outputs are redistributed to the reference's
    ``out_shardings``;
  * ``memory_analysis()`` is byte accounting of rank 0's local shards
    (``memory_dict``), and the HLO walker is ``launch.op_cost``'s per-device
    op counter.

What differs from the reference's numbers: ``hbm_bytes`` is the eager
program's traffic (every op reads and writes memory), not XLA's
fusion-boundary model; the collectives are DTensor's choices, not GSPMD's;
the temporaries are eager's (the new train state is built beside the
donated one, not in place).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --arch smollm_360m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --both-meshes --out results/dryrun_torch

Every ``--arch`` id fails as the reference's does (``get_arch`` knows no
full-size config); ``run_combo(..., cfg_override=...)`` takes published
widths.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, NamedTuple

import torch

from ..configs.base import (ARCH_IDS, INPUT_SHAPES, ArchConfig, InputShape,
                            get_arch)
from ..core.steps import TrainState, make_serve_step, make_train_step
from ..data.pipeline import input_specs
from ..device import resolve_device
from ..models.layers import activation_mesh, whole_dim
from ..tree import tree_leaves, tree_map, tree_unflatten
from . import op_cost
from . import sharding as shd
from .mesh import make_debug_mesh, make_production_mesh, placeholder_group


def shape_overrides(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """Per-shape config adjustments.

    long_500k requires sub-quadratic attention: attention-bearing archs get
    a sliding window (ring-buffer KV cache); SSM archs run natively.
    """
    if shape.name == "long_500k" and cfg.attn != "none" \
            and cfg.block != "rwkv6":
        cfg = cfg.with_(sliding_window=8192)
    return cfg


# ------------------------------------------------------------ abstract state
def _to_meta(tree):
    """Every tensor leaf as a storage-less ``meta`` tensor of its shape,
    stride and dtype."""
    return tree_map(lambda t: torch.empty_strided(
        t.shape, t.stride(), dtype=t.dtype, device="meta")
        if isinstance(t, torch.Tensor) else t, tree)


def abstract(fn, *args):
    """``fn(*args)`` for its shapes only (``jax.eval_shape``): run under
    ``FakeTensorMode``, nothing allocated; the result as meta tensors.
    ``fn`` builds on the CPU (a fake CPU tensor holds nothing either)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        out = fn(*args)
    return _to_meta(out)


def _gen():
    return torch.Generator().manual_seed(0)


def _bytes(tree) -> int:
    """Bytes of this rank's blocks of the tensor leaves of ``tree``."""
    from torch.distributed.tensor import DTensor
    n = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            n += t.numel() * t.element_size()
    return n


def _constrain(tree, shardings):
    """The reference's ``out_shardings``: every DTensor leaf redistributed
    to its ``NamedSharding`` (a no-op where it already is). A plain tensor
    (a constant such as a dense model's zero aux loss) is the same on
    every rank already."""
    from torch.distributed.tensor import DTensor

    def one(x, s):
        if not isinstance(x, DTensor):
            return x
        want = s.placements
        return x if tuple(x.placements) == want \
            else x.redistribute(s.mesh, want)
    return tree_unflatten(tree, [one(x, s) for x, s in
                                 zip(tree_leaves(tree),
                                     tree_leaves(shardings))])


class Traced(NamedTuple):
    """A step ready to trace: ``fn(*args)``, its outputs placed by
    ``out_shardings``; ``donated`` is the part of ``args`` it takes over
    (the train state, or the caches decode writes in place)."""
    fn: Any
    args: tuple
    out_shardings: Any
    donated: Any


def trace_train(cfg: ArchConfig, shape: InputShape, mesh) -> Traced:
    """One optimizer step (``make_train_step``) on the placed state and
    batch; the state is donated."""
    init_state, train_step = make_train_step(cfg, "cpu")
    state = abstract(init_state, _gen())
    batch = input_specs(cfg, shape)
    pspecs = shd.param_specs(state.params, mesh)
    ospecs = shd.opt_state_specs(state.opt_state, pspecs, mesh)
    state_sh = shd.tree_shardings(TrainState(pspecs, ospecs, shd.P()), mesh)
    batch_sh = shd.batch_shardings(cfg, shape, batch, mesh)
    scalar = shd.NamedSharding(mesh, shd.P())
    metrics_sh = {"loss": scalar, "aux": scalar, "grad_norm": scalar}
    placed = shd.distribute(state, state_sh)
    return Traced(train_step, (placed, shd.distribute(batch, batch_sh)),
                  (state_sh, metrics_sh), placed)


def trace_prefill(cfg: ArchConfig, shape: InputShape, mesh) -> Traced:
    """Inference prefill: full forward over (B, S) tokens -> last-position
    greedy tokens. Compute-equivalent to cache-filling prefill (the cache
    writes are free beside the matmuls); no loss, no backward, no
    optimizer."""
    from ..models import transformer as tfm

    def prefill_step(params, batch):
        kwargs = {"tokens": batch["tokens"]}
        if cfg.is_encdec:
            kwargs["src_embeds"] = batch["src_embeds"]
        elif cfg.frontend == "vision":
            kwargs["embeds"] = batch["patch_embeds"]
        with torch.no_grad():
            hidden, _ = tfm.lm_forward(params, cfg, return_hidden=True,
                                       **kwargs)
            logits = hidden[:, -1:] @ params["unemb"]
            return torch.argmax(whole_dim(logits, -1),
                                dim=-1).to(torch.int32)

    params = abstract(lambda g: tfm.init_lm(g, cfg, "cpu"), _gen())
    batch = {k: v for k, v in input_specs(cfg, InputShape(
        shape.name, shape.seq_len, shape.global_batch, "train")).items()
        if k != "labels"}
    p_sh = shd.tree_shardings(shd.param_specs(params, mesh), mesh)
    batch_sh = shd.batch_shardings(cfg, shape, batch, mesh)
    return Traced(prefill_step, (shd.distribute(params, p_sh),
                                 shd.distribute(batch, batch_sh)),
                  shd.NamedSharding(mesh, shd.P()), None)


def trace_serve(cfg: ArchConfig, shape: InputShape, mesh) -> Traced:
    """One greedy decode step (``make_serve_step``) against
    ``seq_len``-deep caches; the caches are donated (written in place)."""
    init_serve, serve_step = make_serve_step(cfg, shape, "cpu")
    params, caches = abstract(init_serve, _gen())
    specs = input_specs(cfg, shape)
    p_sh = shd.tree_shardings(shd.param_specs(params, mesh), mesh)
    c_sh = shd.tree_shardings(shd.cache_specs(cfg, shape, caches, mesh),
                              mesh)
    tok_sh = shd.NamedSharding(mesh, shd.batch_spec(
        cfg, shape, mesh, "token", specs["token"].shape))
    placed = shd.distribute(caches, c_sh)
    args = [shd.distribute(params, p_sh), placed,
            shd.distribute(specs["token"], tok_sh)]
    if "enc_out" in specs:
        enc_sh = shd.NamedSharding(mesh, shd.batch_spec(
            cfg, shape, mesh, "enc_out", specs["enc_out"].shape))
        args.append(shd.distribute(specs["enc_out"], enc_sh))

        def step(params, caches, token, enc_out):
            with torch.no_grad():
                return serve_step(params, caches, token, enc_out=enc_out)
    else:
        def step(params, caches, token):
            with torch.no_grad():
                return serve_step(params, caches, token)
    return Traced(step, tuple(args), (tok_sh, c_sh), placed)


@functools.cache
def _register_strategies():
    """Placements for the ops DTensor has no sharding strategy for, once a
    process: each runs on whole (replicated) inputs, which DTensor gathers
    first. ``searchsorted`` finds each expert's first route in the MoE
    dispatch (``models.moe``)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.searchsorted.Tensor)
    def _whole(sorted_sequence, values, *args, **kwargs):
        return [([Replicate()], [Replicate(), Replicate()]
                 + [None] * len(args))]


def execute(traced: Traced, mesh):
    """Run the traced step once under the op counter, on ``mesh``: ->
    (memory_dict, op counts)."""
    from torch.distributed.tensor.experimental import implicit_replication
    _register_strategies()
    counter = op_cost.CostCounter()
    args_bytes = counter.track(traced.args)
    with counter:
        with activation_mesh(mesh), implicit_replication():
            out = _constrain(traced.fn(*traced.args), traced.out_shardings)
    name = getattr(traced.fn, "__qualname__", "step")
    cost = counter.cost(name)
    axis_of = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    cost["collectives_by_axis"] = {axis_of.get(g, g): v for g, v in
                                   counter.by_group.items()}
    return memory_dict(args_bytes, _bytes(out), _bytes(traced.donated),
                       counter.peak_bytes), cost


def memory_dict(args_bytes, out_bytes, alias_bytes, peak_bytes) -> dict:
    """The reference's ``memory_analysis()`` keys, per device: arguments
    (state, batch, caches), outputs, the outputs that reuse donated
    arguments, and the temporaries: the peak of live bytes during the step
    less the arguments."""
    return {"argument_size_in_bytes": int(args_bytes),
            "output_size_in_bytes": int(out_bytes),
            "temp_size_in_bytes": int(peak_bytes - args_bytes),
            "alias_size_in_bytes": int(alias_bytes)}


def cost_dict(cost: dict) -> dict:
    """The counter's own totals under XLA's ``cost_analysis()`` names."""
    return {"flops": float(cost["flops"]),
            "bytes accessed": float(cost["hbm_bytes"])}


_TRACE = {"train": trace_train, "prefill": trace_prefill,
          "decode": trace_serve}


def run_combo(arch_id: str, shape_name: str, multi_pod: bool,
              cfg_override=None, device=None, *, shape=None,
              debug_mesh=None):
    """Trace one (arch, shape) on a production mesh (``multi_pod``: the
    2x16x16 one) and return its record, the reference's keys: ``ok``,
    ``lower_s`` (state built and placed), ``compile_s`` (the traced step),
    ``memory``, ``cost_raw``, ``flops``, ``hbm_bytes``, ``collectives``,
    ``collective_bytes``, ``n_devices``, ``params``, ``active_params``,
    ``seq_len``, ``global_batch``, ``total_s``, or ``error`` and
    ``traceback``. ``shape`` (an ``InputShape``) replaces the named one;
    ``debug_mesh`` = (data, model) traces on that small mesh instead.
    ``device`` (default: CUDA) is the type of the mesh: the tensors
    themselves hold no storage."""
    shape = shape or INPUT_SHAPES[shape_name]
    mesh_name = ("x".join(map(str, debug_mesh)) if debug_mesh
                 else "2x16x16" if multi_pod else "16x16")
    rec = {"arch": arch_id, "shape": shape.name, "mesh": mesh_name,
           "mode": shape.mode, "ok": False}
    t0 = time.perf_counter()
    try:
        # inside the try: get_arch raises for ids whose full-size config
        # module was removed — record that like any other sweep failure
        cfg = cfg_override or get_arch(arch_id)
        cfg = shape_overrides(cfg, shape)
        dev = resolve_device(device)
        n = math.prod(debug_mesh) if debug_mesh else \
            512 if multi_pod else 256
        with placeholder_group(n):
            mesh = (make_debug_mesh(*debug_mesh, device=dev) if debug_mesh
                    else make_production_mesh(multi_pod=multi_pod,
                                              device=dev))
            traced = _TRACE[shape.mode](cfg, shape, mesh)
            t1 = time.perf_counter()
            mem, walk = execute(traced, mesh)
            del traced
        t2 = time.perf_counter()
        print(f"  memory (per device): {mem}")
        print(f"  op count (per device): flops={walk['flops']:.3e} "
              f"hbm_bytes={walk['hbm_bytes']:.3e} "
              f"collective_bytes={walk['collective_bytes']:.3e}")
        rec.update(ok=True, lower_s=t1 - t0, compile_s=t2 - t1, memory=mem,
                   cost_raw=cost_dict(walk), flops=walk["flops"],
                   hbm_bytes=walk["hbm_bytes"],
                   collectives=walk["collectives"],
                   collective_bytes=walk["collective_bytes"],
                   collectives_by_axis=walk["collectives_by_axis"],
                   n_devices=n, device=dev.type,
                   params=int(cfg.param_count()),
                   active_params=int(cfg.active_param_count()),
                   seq_len=shape.seq_len, global_batch=shape.global_batch)
    except Exception as e:  # glint: disable=GL012 the sweep records every failure (get_arch's, an op DTensor cannot place, a shape error) in the record with its traceback and goes on; main() exits 1 if any combo failed
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = time.perf_counter() - t0
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="input shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="mesh device type: 'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
                path = outdir / f"{tag}.json"
                if args.skip_existing and path.exists():
                    old = json.loads(path.read_text())
                    if old.get("ok"):
                        print(f"[skip] {tag}")
                        continue
                print(f"[dryrun] {tag} ...", flush=True)
                rec = run_combo(arch, shape, mp, device=args.device)
                path.write_text(json.dumps(rec, indent=1))
                status = "OK" if rec["ok"] else f"FAIL ({rec.get('error')})"
                n_fail += 0 if rec["ok"] else 1
                print(f"[dryrun] {tag}: {status} "
                      f"({rec['total_s']:.1f}s)", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
