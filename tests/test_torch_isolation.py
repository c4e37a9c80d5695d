"""The port stands alone: no jax, no ``repro``, no silent CPU fallback.

  * an AST scan: nothing under ``src/repro_torch/`` and not
    ``chip_smoke.py`` imports ``jax`` or ``repro``;
  * every module imports in a fresh interpreter where ``triton`` cannot be
    imported, and leaves no jax module behind;
  * entry points default to CUDA and raise where there is none;
  * ``chip_smoke.py`` exits non-zero and prints no result without CUDA,
    and without the rest of the repository beside it.
"""
import ast
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import ExperimentConfig, Trainer, make_backend
from repro_torch.core import checkpoint, glasu
from repro_torch.device import resolve_device
from repro_torch.graph.synth import make_vfl_dataset
from repro_torch.serve import InferenceSession

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [SMOKE]


def _imported_modules(path):
    """Absolute module names a file imports (relative imports stay inside
    its own package and are skipped)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_reference(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {name}"


def test_every_module_imports_without_triton_or_jax():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(PORT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(("repro_torch",) + parts))
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"      # `import triton` now raises
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    assert {"repro_torch.models.moe", "repro_torch.models.ssm",
            "repro_torch.launch.train", "repro_torch.core.steps"} <= set(mods)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device resolves")


def test_default_device_is_cuda_and_raises_without_it():
    _no_cuda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        checkpoint.params_from_numpy({"W": np.ones(2, np.float32)})
    params = checkpoint.params_from_numpy({"W": np.ones(2, np.float32)},
                                          "cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        InferenceSession(params, ExperimentConfig(dataset="tiny"))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        Trainer(ExperimentConfig(dataset="tiny"))
    with pytest.raises(RuntimeError, match="cuda"):
        glasu.init_params(torch.Generator().manual_seed(0),
                          glasu.GlasuConfig())
    from repro_torch.configs.base import get_reduced
    from repro_torch.core.steps import make_train_step
    from repro_torch.launch import train
    init, _ = make_train_step(get_reduced("smollm_360m"))
    with pytest.raises(RuntimeError, match="is_available"):
        init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="is_available"):
        train.main(["--steps", "1"])


def test_unported_training_options_raise(monkeypatch):
    """What the port still refuses: the flash kernel's backward on the card
    (the reference cannot differentiate its Pallas kernel either). Every
    backend and serve engine of the reference is ported and runs on the
    CPU, and so does every transformer family's training step
    (tests/test_torch_families.py holds them to the reference)."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.core import steps
    from repro_torch.kernels import ops
    q = torch.zeros(1, 4, 2, 8, requires_grad=True)
    kv = torch.zeros(1, 4, 2, 8)
    monkeypatch.setattr(ops, "_device", lambda name, t: "cuda")
    with pytest.raises(NotImplementedError,
                       match="pallas_call has no reverse-mode rule"):
        ops.flash_attention(q, kv, kv)
    monkeypatch.undo()
    init, step = steps.make_train_step(get_reduced("phi35_moe_42b"), "cpu")
    assert init(torch.Generator().manual_seed(0)).step == 0
    tiny = dict(dataset="tiny", hidden=8, batch_size=8, size_cap=96)
    with pytest.raises(ValueError, match="unknown backend"):
        make_backend("mpi")
    for name in ("simulation", "sharded"):
        trainer = Trainer(ExperimentConfig(backend=name, rounds=1,
                                           eval_every=1, **tiny),
                          device="cpu")
        assert trainer.backend.name == name
        assert trainer.run().comm_bytes > 0
        trainer.close()
    params = glasu.init_params(
        torch.Generator().manual_seed(0),
        ExperimentConfig(**tiny).glasu_config(make_vfl_dataset("tiny")),
        "cpu")
    for serve in ({"engine": "sharded"}, {"record_log": True}):
        sess = InferenceSession(params, ExperimentConfig(**tiny),
                                serve=serve, device="cpu")
        assert sess.answer([0, 1]).wire_bytes > 0
        sess.close()
    trainer = Trainer(ExperimentConfig(rounds=1, eval_every=1, **tiny),
                      device="cpu")
    assert trainer.device == torch.device("cpu")
    assert trainer.run().params["inp"]["W"].device == torch.device("cpu")


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def _assert_no_result(out):
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            blob = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(blob, dict) and blob.get("ok")), line


def test_chip_smoke_fails_without_cuda():
    _no_cuda()
    out = _run_smoke(ROOT)
    _assert_no_result(out)
    assert "CUDA" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    _assert_no_result(out)
