"""The port covers the reference's whole public surface (read from the
sources' ASTs; neither package is imported).

For every module under ``src/repro/``, each public top-level ``def`` and
``class``, each public method of a public class, and each member of a
package's ``__all__`` has either

  * a counterpart of the same name in the same module of
    ``src/repro_torch/``: defined there (a ``def``, ``class`` or
    assignment), a method defined in the class or inherited from a base
    class of that module, an ``__all__`` member exported by the port's
    package; or
  * an entry in ``JAX_ONLY``, which names its stand-in in the port and says
    why the name itself has no port. A class's entry covers its methods.

``JAX_ONLY`` holds exactly the names that have no counterpart, and every
stand-in it names exists, so a name added to ``src/repro/`` fails here
until the port follows it (or the table says why it need not).
"""
import ast
import functools
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

_SHARD_MAP = "a shard_map program over a 'clients' mesh axis; the port " \
             "runs the same function on a torch.distributed client mesh " \
             "(mesh=)"
_PALLAS = "a Pallas TPU kernel; the port's hand-written sm_90a kernel " \
          "computes the same function"
_XLA = "lowers and compiles for XLA and reads the HLO; the port traces " \
       "on DTensor and counts per-device ops and collectives"

# "module:name" -> ("module:stand-in", why the name has no port of its own)
JAX_ONLY = {
    "core/glasu.py:ExecPolicy": (
        "core/glasu.py:make_round_fn",
        "shard_map's execution policy (and its .sharded flag); the port's "
        "round functions take mesh= instead"),
    "core/glasu.py:make_sharded_round_fn": ("core/glasu.py:make_round_fn",
                                            _SHARD_MAP),
    "core/glasu.py:make_sharded_multi_round_fn": (
        "core/glasu.py:make_multi_round_fn", _SHARD_MAP),
    "core/glasu.py:make_sharded_joint_fn": ("core/glasu.py:joint_inference",
                                            _SHARD_MAP),
    "core/glasu.py:sharded_joint_inference": (
        "core/glasu.py:joint_inference", _SHARD_MAP),
    "core/glasu.py:make_sharded_serve_fn": ("core/glasu.py:serve_forward",
                                            _SHARD_MAP),
    "core/glasu.py:sharded_serve_forward": ("core/glasu.py:serve_forward",
                                            _SHARD_MAP),
    "kernels/graph_agg.py:graph_agg_pallas": (
        "kernels/graph_agg.py:graph_agg_cuda", _PALLAS),
    "kernels/graph_agg.py:graph_agg_csr_pallas": (
        "kernels/graph_agg.py:graph_agg_csr_cuda", _PALLAS),
    "kernels/graph_agg.py:gcnii_layer_pallas": (
        "kernels/graph_agg.py:gcnii_layer_cuda", _PALLAS),
    "kernels/graph_agg.py:gat_layer_pallas": (
        "kernels/graph_agg.py:gat_layer_cuda", _PALLAS),
    "kernels/flash_attention.py:flash_attention_pallas": (
        "kernels/flash_attention.py:flash_attention_cuda", _PALLAS),
    "launch/dryrun.py:lower_train": ("launch/dryrun.py:trace_train", _XLA),
    "launch/dryrun.py:lower_prefill": ("launch/dryrun.py:trace_prefill",
                                       _XLA),
    "launch/dryrun.py:lower_serve": ("launch/dryrun.py:trace_serve", _XLA),
    "launch/dryrun.py:parse_collectives": ("launch/op_cost.py:CostCounter",
                                           _XLA),
    "launch/hlo_cost.py:HloCost": ("launch/op_cost.py:CostCounter", _XLA),
    "launch/hlo_cost.py:Instr": ("launch/op_cost.py:CostCounter", _XLA),
    "launch/hlo_cost.py:analyze": ("launch/op_cost.py:measure", _XLA),
    "launch/sharding.py:param_shardings": (
        "launch/sharding.py:param_specs",
        "jax NamedShardings; the port places param_specs as DTensors "
        "(launch/sharding.py distribute)"),
}


class _Module:
    """The surface of one source file: its top-level ``def`` and ``class``
    names (``defs``), those and its assignments (``defined``), every name
    it binds (``bound``: those and its imports), its classes with their
    methods and bases, and ``__all__``."""

    def __init__(self, path: pathlib.Path):
        self.exists = path.is_file()
        self.defs, self.defined, self.bound = set(), set(), set()
        self.classes, self.all = {}, []
        if not self.exists:
            return
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                self.defs.add(node.name)
                if isinstance(node, ast.ClassDef):
                    self.classes[node.name] = node
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        self.defined.add(t.id)
                        if t.id == "__all__":
                            self.all = list(ast.literal_eval(node.value))
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                self.bound.update((a.asname or a.name).split(".")[0]
                                  for a in node.names)
        self.defined |= self.defs
        self.bound |= self.defined

    def methods(self, cls: str) -> set:
        return {n.name for n in self.classes[cls].body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    def has_method(self, cls: str, name: str, seen=()) -> bool:
        """``name`` defined on ``cls`` or on a base class of this module."""
        if cls not in self.classes or cls in seen:
            return False
        if name in self.methods(cls):
            return True
        return any(isinstance(b, ast.Name)
                   and self.has_method(b.id, name, seen + (cls,))
                   for b in self.classes[cls].bases)


@functools.lru_cache(maxsize=None)
def _module(path: pathlib.Path) -> _Module:
    return _Module(path)


def _public(name: str) -> bool:
    return not name.startswith("_")


def _ref_names(rel: str) -> list:
    """Every public name of a reference module: top-level definitions
    (``Name``), public methods of public classes (``Class.method``), and
    ``__all__`` members (``__all__:Name``)."""
    mod = _module(REF / rel)
    names = [n for n in sorted(mod.defs) if _public(n)]
    for cls in sorted(c for c in mod.classes if _public(c)):
        names += [f"{cls}.{m}" for m in sorted(mod.methods(cls))
                  if _public(m)]
    return names + [f"__all__:{n}" for n in mod.all]


def _has_counterpart(rel: str, name: str) -> bool:
    port = _module(PORT / rel)
    if name.startswith("__all__:"):
        name = name.split(":", 1)[1]
        return name in port.all and name in port.bound
    if "." in name:
        return port.has_method(*name.split("."))
    return name in port.defined


def _covered(rel: str, name: str) -> bool:
    """In ``JAX_ONLY`` itself, or a method of a class that is."""
    return f"{rel}:{name.split('.')[0]}" in JAX_ONLY


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _missing(rel: str) -> list:
    return [n for n in _ref_names(rel) if not _has_counterpart(rel, n)]


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    uncovered = [n for n in _missing(rel) if not _covered(rel, n)]
    assert not uncovered, (
        f"src/repro/{rel}: {uncovered} have no counterpart in "
        f"src/repro_torch/{rel} and no JAX_ONLY entry")


def test_jax_only_holds_exactly_the_names_without_a_port():
    """No stale entry: every entry names a reference name the port lacks
    (a method of an entered class is covered by the class's entry)."""
    missing = {f"{rel}:{n.split('.')[0]}"
               for rel in REF_MODULES for n in _missing(rel)}
    assert missing == set(JAX_ONLY)
    assert len(JAX_ONLY) == 20


@pytest.mark.parametrize("entry", sorted(JAX_ONLY))
def test_jax_only_stand_in_exists(entry):
    stand_in, reason = JAX_ONLY[entry]
    rel, name = stand_in.split(":")
    assert _has_counterpart(rel, name), f"{entry}: no {stand_in} in the port"
    rel_ref, ref_name = entry.split(":")
    assert ref_name in _module(REF / rel_ref).defs, entry
    assert reason


def test_surface_scan_sees_the_legacy_surface_and_inheritance():
    """The names this check exists for are found as real counterparts: the
    legacy training surface, ``Backend``, the package exports, and the
    backends' ``run_round`` / ``run_step``, inherited from the port's
    ``_CarryBackend``."""
    for rel, name in (("core/train.py", "train_glasu"),
                      ("core/train.py", "make_optimizer"),
                      ("api/config.py", "ExperimentConfig.from_legacy"),
                      ("api/backends.py", "Backend"),
                      ("api/backends.py", "VmappedBackend.run_round"),
                      ("api/backends.py", "ShardedBackend.run_step"),
                      ("api/__init__.py", "__all__:Backend"),
                      ("api/__init__.py", "__all__:step_schedule"),
                      ("comm/__init__.py", "__all__:make_compressor"),
                      ("serve/__init__.py", "__all__:MicroBatcher")):
        assert name in _ref_names(rel), (rel, name)
        assert _has_counterpart(rel, name), (rel, name)
    assert not _has_counterpart("core/glasu.py", "ExecPolicy")
