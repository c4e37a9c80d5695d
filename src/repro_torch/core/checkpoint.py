"""Checkpointing in the JAX package's npz layout: save, restore, cleanup.

The reference (``repro.core.checkpoint``) stores a tree as ONE flat npz
leaf list (``leaf_<i>`` plus a ``__meta__`` JSON of the count and dtypes)
in ``jax.tree_util.tree_flatten`` order, bf16 leaves as their 16-bit
patterns. This module writes and reads that layout without jax by
rebuilding the flatten order itself (``repro_torch.tree``):

  * dict keys are sorted (``opt_state`` before ``params``; ``W`` before
    ``a_dst`` before ``a_src`` before ``b``; the int layer keys of the
    error-feedback and fault sidecars numerically);
  * NamedTuple fields and lists keep their order (``AdamState(step, mu,
    nu)``, ``SGDState(step, momentum | None)``);
  * ``None`` holds no leaf; a Python int (the optimizers' step counter) is
    a 0-d int32 leaf, as the reference's counter is.

So the reference restores what ``save`` writes, and ``restore`` reads what
the reference saved: ``ckpt_<step>.npz`` (params and optimizer state) and
its step-aligned sidecars ``comp_<step>.npz`` (error-feedback
accumulators) and ``fault_<step>.npz`` (stale-embedding caches). Device
tensors are copied to the host to be saved and restored onto the device of
the tree they replace. A missing file raises FileNotFoundError; a
truncated, garbled or mismatched one raises RuntimeError naming the file.

``params_from_numpy`` turns a reference parameter tree (numpy or jax array
leaves, client-stacked) into the port's tree of torch tensors;
``load_for_inference`` restores the params alone for serving.
"""
from __future__ import annotations

import json
import zipfile
from pathlib import Path
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..tree import tree_leaves, tree_map, tree_unflatten

# param-shaped copies each optimizer's state holds after its step counter
# (repro.optim.optimizers: SGDState(step, None) for sgd, SGDState(step,
# momentum) for momentum, AdamState(step, mu, nu) for adam and adamw)
OPT_STATE_COPIES = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 2}


def _bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """bfloat16 tensor from its 16-bit patterns (numpy has no bf16)."""
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return _bf16_from_bits(arr.view(np.uint16))
    return torch.from_numpy(np.array(arr, copy=True, order="C"))


def params_from_numpy(tree, device=None):
    """Reference parameter tree ``{"inp", "layers": [...], "cls"}`` (leaves
    numpy arrays, or anything ``np.asarray`` takes) -> the same tree of
    contiguous torch tensors on ``device`` (default: CUDA)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a).to(dev), tree)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the numpy array the reference stores: bf16 as uint16 bit
    patterns, a Python int as 0-d int32."""
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(tree) -> Tuple[dict, str]:
    leaves = tree_leaves(tree)
    arrays, metas = {}, []
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i}"] = _to_numpy(leaf)
        metas.append("bfloat16" if isinstance(leaf, torch.Tensor)
                     and leaf.dtype == torch.bfloat16
                     else str(arrays[f"leaf_{i}"].dtype))
    return arrays, json.dumps({"n": len(leaves), "dtypes": metas,
                               "treedef": "repro_torch.tree flatten order"})


def save(ckpt_dir: str, step: int, tree: Any, name: str = "ckpt") -> str:
    """Save a tree as ``<name>_<step>.npz``. ``name="ckpt"`` is the main
    training state and advances the LATEST pointer; other names are
    step-aligned sidecars (``"comp"``, ``"fault"``)."""
    path = Path(ckpt_dir)
    path.mkdir(parents=True, exist_ok=True)
    arrays, meta = _flatten(tree)
    fn = path / f"{name}_{step:08d}.npz"
    np.savez(fn, __meta__=np.frombuffer(meta.encode(), dtype=np.uint8),
             **arrays)
    if name == "ckpt":
        (path / "LATEST").write_text(str(step))
    return str(fn)


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = Path(ckpt_dir) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def _open(fn: Path):
    """The npz and its meta, or RuntimeError naming a corrupt file."""
    try:
        blob = np.load(fn)
        meta = json.loads(bytes(blob["__meta__"]).decode())
    except (zipfile.BadZipFile, OSError, ValueError, KeyError,
            json.JSONDecodeError) as e:
        raise RuntimeError(
            f"corrupt checkpoint {fn}: {type(e).__name__}: {e}") from e
    return blob, meta


def _leaf(blob, fn: Path, i: int) -> np.ndarray:
    try:
        return blob[f"leaf_{i}"]
    except (zipfile.BadZipFile, KeyError, OSError, ValueError) as e:
        raise RuntimeError(
            f"corrupt checkpoint {fn}: leaf_{i} unreadable: "
            f"{type(e).__name__}: {e}") from e


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            name: str = "ckpt") -> Any:
    """Restore into the structure of ``like`` (an example tree), each
    tensor leaf onto the device of the leaf it replaces, an int leaf as an
    int. A missing file raises FileNotFoundError; a truncated, garbled or
    structurally mismatched npz (leaf count or shape) raises RuntimeError
    naming the file."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    fn = Path(ckpt_dir) / f"{name}_{step:08d}.npz"
    if not fn.exists():
        raise FileNotFoundError(
            f"no {name} checkpoint for step {step} in {ckpt_dir}; found: "
            f"{sorted(f.name for f in Path(ckpt_dir).glob(f'{name}_*.npz'))}")
    blob, meta = _open(fn)
    like_leaves = tree_leaves(like)
    if meta["n"] != len(like_leaves):
        raise RuntimeError(
            f"corrupt/mismatched checkpoint {fn}: stores {meta['n']} "
            f"leaves, restore target has {len(like_leaves)}")
    leaves = []
    for i, (dt, want) in enumerate(zip(meta["dtypes"], like_leaves)):
        arr = _leaf(blob, fn, i)
        if isinstance(want, int):
            leaves.append(int(arr))
            continue
        t = _bf16_from_bits(arr) if dt == "bfloat16" \
            else torch.from_numpy(np.array(arr, copy=True, order="C"))
        if tuple(t.shape) != tuple(want.shape):
            raise RuntimeError(
                f"corrupt/mismatched checkpoint {fn}: leaf_{i} shape "
                f"{tuple(t.shape)} != expected {tuple(want.shape)}")
        leaves.append(t.to(want.device))
    return tree_unflatten(like, leaves)


def cleanup(ckpt_dir: str, keep: int = 3):
    """Keep the newest ``keep`` main checkpoints; the sidecars are pruned
    by the trainer's CheckpointHook against the surviving steps."""
    files = sorted(Path(ckpt_dir).glob("ckpt_*.npz"))
    for f in files[:-keep]:
        f.unlink()


class InferenceRestore(NamedTuple):
    """``load_for_inference`` result: exactly what a serving process needs."""
    params: Any            # the trained per-client parameter stack
    config: Any            # ExperimentConfig that wrote the checkpoint
    step: int              # training round the params were saved at
    data: Any              # VFLDataset the config binds to


def load_for_inference(ckpt_dir: str, step: Optional[int] = None,
                       data=None, device=None) -> InferenceRestore:
    """Restore PARAMS ONLY from a reference training checkpoint.

    Rebuilds the model from ``experiment.json``, marks the trailing leaves
    of the flat list as the params (``params`` sorts after ``opt_state``)
    and reads only those members of the npz. Errors are loud, as in the
    reference: no ``experiment.json`` or no such step -> FileNotFoundError;
    corrupt npz, leaf-count, shape or dtype mismatch -> RuntimeError; an
    optimizer whose state layout the port does not know -> ValueError.
    """
    from ..api.config import ExperimentConfig
    from . import glasu

    dev = resolve_device(device)
    path = Path(ckpt_dir)
    meta_file = path / "experiment.json"
    if not meta_file.exists():
        raise FileNotFoundError(
            f"no experiment.json in {ckpt_dir}: cannot reconstruct the "
            "model structure this checkpoint's leaves belong to")
    cfg = ExperimentConfig.from_dict(json.loads(meta_file.read_text()))
    if cfg.optimizer not in OPT_STATE_COPIES:
        raise ValueError(
            f"checkpoint optimizer {cfg.optimizer!r}: the port restores "
            f"the state layouts of {sorted(OPT_STATE_COPIES)} only (not "
            "ported yet)")

    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(
            f"no LATEST pointer in {ckpt_dir} and no explicit step given; "
            f"found: {sorted(f.name for f in path.glob('ckpt_*.npz'))}")
    fn = path / f"ckpt_{step:08d}.npz"
    if not fn.exists():
        raise FileNotFoundError(
            f"no checkpoint for step {step} in {ckpt_dir}; found: "
            f"{sorted(f.name for f in path.glob('ckpt_*.npz'))}")

    if data is None:
        from ..graph.synth import make_vfl_dataset
        data = make_vfl_dataset(cfg.dataset, n_clients=cfg.n_clients,
                                seed=cfg.seed)
        if cfg.method == "centralized":
            from .train import make_centralized_dataset
            data = make_centralized_dataset(data)
    mcfg = cfg.glasu_config(data)
    like = glasu.init_params(torch.Generator().manual_seed(0), mcfg, "cpu")
    like_leaves = tree_leaves(like)
    n_params = len(like_leaves)
    n_opt = 1 + OPT_STATE_COPIES[cfg.optimizer] * n_params

    blob, meta = _open(fn)
    if meta["n"] != n_opt + n_params:
        raise RuntimeError(
            f"corrupt/mismatched checkpoint {fn}: stores {meta['n']} "
            f"leaves, the config's params+opt_state tree has "
            f"{n_opt + n_params} (different optimizer or model than "
            "experiment.json claims?)")
    leaves = []
    for i, want in zip(range(n_opt, n_opt + n_params), like_leaves):
        dt = meta["dtypes"][i]
        arr = _leaf(blob, fn, i)
        if dt == "bfloat16":
            t = _bf16_from_bits(arr)
        elif dt == "float32":
            t = torch.from_numpy(np.ascontiguousarray(arr))
        else:
            raise RuntimeError(
                f"corrupt/mismatched checkpoint {fn}: params leaf_{i} has "
                f"dtype {dt}, expected float32 or bfloat16")
        if tuple(t.shape) != tuple(want.shape):
            raise RuntimeError(
                f"corrupt/mismatched checkpoint {fn}: params leaf shape "
                f"{tuple(t.shape)} != expected {tuple(want.shape)}")
        leaves.append(t.to(dev))
    params = tree_unflatten(like, leaves)
    return InferenceRestore(params=params, config=cfg, step=int(step),
                            data=data)
