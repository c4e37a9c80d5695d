"""Port parity: the multi-pod dry-run's placement rules, its op counter and
its records, against the JAX package on the CPU.

  * spec parity: ``param_specs``, ``opt_state_specs`` (AdamW, SGD with
    momentum, Adafactor), ``batch_spec`` over every ``input_specs`` entry
    and ``cache_specs`` (``decode_32k``, and ``long_500k`` after
    ``shape_overrides``) equal the reference's leaf by leaf, on the 16x16
    and 2x16x16 meshes (the reference's on an ``AbstractMesh`` over
    ``jax.eval_shape`` trees, the port's on a ``DeviceMesh`` over a
    placeholder group), for the 10 reduced configs and for SmolLM-360M and
    llama3-405b at their published widths (the only ones whose weights
    cross ``_add_fsdp``'s 16 MiB);
  * the op counter counts every loop trip (the reference's walker
    numbers, ``tests/test_infra.py``);
  * a reduced SmolLM train record on the placeholder 16x16 mesh: ok, no
    work lost to sharding, a gradient reduction over 'data', no group
    left behind; ``benchmarks/roofline.py`` reads the record;
  * failures are records (``get_arch``), the placeholder group refuses a
    live one, and importing the dry-run touches nothing;
  * with no mesh the sharding shim returns its argument itself, and on a
    1x1 mesh the DTensor forms (the masked-sum CE, the select cache write,
    the reshapes) give the plain path's values.

The 1x1 cost parity against ``hlo_cost`` lives in
``tests/test_torch_dryrun_cost.py``.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.launch import sharding as jshd
from repro.models import transformer as jtfm
from repro.optim import optimizers as jopt
from repro_torch.configs import base as tbase
from repro_torch.core import steps as tsteps
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import op_cost
from repro_torch.launch import sharding as tshd
from repro_torch.launch.mesh import (make_debug_mesh, make_production_mesh,
                                     placeholder_group)
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.optim import optimizers as topt
from repro_torch.tree import tree_leaves, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# published widths (``git show 45395fd:src/repro/configs/<id>.py``)
PUBLISHED = {
    "smollm_360m_full": dict(
        name="smollm-360m", kind="dense", n_layers=32, d_model=960,
        n_heads=15, n_kv=5, d_head=64, d_ff=2560, vocab=49152,
        dtype="bfloat16", optimizer="adamw", lr=3e-4),
    "llama3_405b_full": dict(
        name="llama3-405b", kind="dense", n_layers=126, d_model=16384,
        n_heads=128, n_kv=8, d_head=128, d_ff=53248, vocab=128256,
        grad_accum=4, rope_theta=500000.0, dtype="bfloat16",
        optimizer="adafactor", lr=8e-5),
}
CONFIGS = list(jbase.ARCH_IDS) + list(PUBLISHED)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
OPTIMIZERS = ("adamw", "momentum", "adafactor")


def _cfgs(name):
    if name in PUBLISHED:
        kw = PUBLISHED[name]
        return jbase.ArchConfig(**kw), tbase.ArchConfig(**kw)
    return jbase.get_reduced(name), tbase.get_reduced(name)


_TREES = {}


def _trees(name):
    """(reference, port) abstract parameters and decode caches of both
    cache shapes, built once per config."""
    if name not in _TREES:
        jcfg, tcfg = _cfgs(name)
        key = jax.random.PRNGKey(0)
        ref = {"params": jax.eval_shape(lambda k: jtfm.init_lm(k, jcfg), key)}
        port = {"params": tdry.abstract(
            lambda g: ttfm.init_lm(g, tcfg, "cpu"), torch.Generator())}
        for shape_name in ("decode_32k", "long_500k"):
            jshape = jbase.INPUT_SHAPES[shape_name]
            tshape = tbase.INPUT_SHAPES[shape_name]
            jc = _override(jcfg, jshape)
            tc = tdry.shape_overrides(tcfg, tshape)
            ref[shape_name] = jax.eval_shape(
                lambda: jtfm.init_caches(jc, jshape.global_batch,
                                         jshape.seq_len, jshape.seq_len - 1))
            port[shape_name] = tdry.abstract(
                lambda: ttfm.init_caches(tc, tshape.global_batch,
                                         tshape.seq_len, tshape.seq_len - 1,
                                         device="cpu"))
        _TREES[name] = (ref, port)
    return _TREES[name]


def _override(cfg, shape):
    """The reference's ``shape_overrides`` (its module sets XLA_FLAGS on
    import, so the rule is restated here and held to the port's below)."""
    if shape.name == "long_500k" and cfg.attn != "none" \
            and cfg.block != "rwkv6":
        cfg = cfg.with_(sliding_window=8192)
    return cfg


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


def _same(ref_specs, port_specs, what):
    ref = [tuple(s) for s in _jleaves(ref_specs)]
    port = [tuple(s) for s in tree_leaves(port_specs)]
    assert len(ref) == len(port), what
    for i, (r, p) in enumerate(zip(ref, port)):
        assert r == p, f"{what}: leaf {i}: reference {r}, port {p}"


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_specs_match_reference(name, mesh_name):
    jcfg, tcfg = _cfgs(name)
    ref, port = _trees(name)
    sizes, axes = MESHES[mesh_name]
    jmesh = AbstractMesh(sizes, axes)
    with placeholder_group(int(np.prod(sizes))):
        tmesh = make_production_mesh(multi_pod=len(sizes) == 3,
                                     device="cpu")
        jp = jshd.param_specs(ref["params"], jmesh)
        tp = tshd.param_specs(port["params"], tmesh)
        _same(jp, tp, "param_specs")
        for opt_name in OPTIMIZERS:
            jopt_state = jax.eval_shape(
                jopt.make_optimizer(opt_name, 1e-3).init, ref["params"])
            topt_state = topt.make_optimizer(opt_name, 1e-3).init(
                port["params"])
            _same(jshd.opt_state_specs(jopt_state, jp, jmesh),
                  tshd.opt_state_specs(topt_state, tp, tmesh),
                  f"opt_state_specs[{opt_name}]")
        for shape_name, jshape in jbase.INPUT_SHAPES.items():
            tshape = tbase.INPUT_SHAPES[shape_name]
            jin = jpipe.input_specs(jcfg, jshape)
            tin = tpipe.input_specs(tcfg, tshape)
            assert list(jin) == list(tin)
            for k in jin:
                assert tuple(jin[k].shape) == tuple(tin[k].shape)
                assert str(jin[k].dtype) == str(tin[k].dtype).split(".")[-1]
                assert tuple(jshd.batch_spec(jcfg, jshape, jmesh, k,
                                             jin[k].shape)) == \
                    tuple(tshd.batch_spec(tcfg, tshape, tmesh, k,
                                          tin[k].shape)), (shape_name, k)
        for shape_name in ("decode_32k", "long_500k"):
            jshape = jbase.INPUT_SHAPES[shape_name]
            tshape = tbase.INPUT_SHAPES[shape_name]
            _same(jshd.cache_specs(_override(jcfg, jshape), jshape,
                                   ref[shape_name], jmesh),
                  tshd.cache_specs(tdry.shape_overrides(tcfg, tshape),
                                   tshape, port[shape_name], tmesh),
                  f"cache_specs[{shape_name}]")
    assert not dist.is_initialized()


def test_shape_overrides_match_reference_rule():
    for arch in jbase.ARCH_IDS:
        for shape_name in jbase.INPUT_SHAPES:
            j = _override(jbase.get_reduced(arch),
                          jbase.INPUT_SHAPES[shape_name])
            t = tdry.shape_overrides(tbase.get_reduced(arch),
                                     tbase.INPUT_SHAPES[shape_name])
            assert j.sliding_window == t.sliding_window, (arch, shape_name)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    with placeholder_group(512):
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        assert tshd.placements(tshd.P(("pod", "data"), None, "model"),
                               mesh) == (Shard(0), Shard(0), Shard(2))
        assert tshd.placements(tshd.P(None, "data"), mesh) == (
            Replicate(), Shard(1), Replicate())
        x = torch.empty(64, 32, device="meta")
        d = tshd.distribute(x, tshd.NamedSharding(
            mesh, tshd.P(("pod", "data"), "model")))
        assert tuple(d.to_local().shape) == (2, 2)
        assert tuple(d.shape) == (64, 32)
    assert not dist.is_initialized()


# ------------------------------------------------------------ op counter
def test_op_counter_counts_loop_trips():
    """The reference walker's numbers (tests/test_infra.py)."""
    def ten(x):
        for _ in range(10):
            x = x @ x
        return x

    r = op_cost.measure(ten, torch.zeros(128, 128))
    assert r["flops"] == 10 * 2 * 128 ** 3
    assert r["collectives"] == {} and r["collective_bytes"] == 0

    def nested(x):
        for _ in range(3):
            for _ in range(5):
                x = x @ x
        return x

    r = op_cost.measure(nested, torch.zeros(64, 64))
    assert r["flops"] == 15 * 2 * 64 ** 3
    assert r["hbm_bytes"] > 15 * 2 * 64 * 64 * 4
    assert r["entry"].endswith("nested")


def test_op_counter_counts_what_the_reference_counts():
    """Matmuls and convolutions only; a view moves no bytes; peak bytes
    cover the arguments and the live temporaries."""
    a, b = torch.zeros(8, 16), torch.zeros(16, 4)
    with op_cost.CostCounter() as c:
        c.track((a, b))
        y = torch.relu(a @ b)               # 2·8·4·16 flops, relu none
        y.reshape(32)                       # a view: no bytes
    assert c.flops == 2 * 8 * 4 * 16
    assert c.hbm_bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4 + 2 * 8 * 4 * 4
    assert c.peak_bytes == (8 * 16 + 16 * 4 + 2 * 8 * 4) * 4
    x = torch.zeros(1, 3, 8, 8)
    w = torch.zeros(5, 3, 3, 3)
    r = op_cost.measure(torch.nn.functional.conv2d, x, w)
    assert r["flops"] == 2 * (5 * 6 * 6) * (3 * 3 * 3)


# ------------------------------------------------- the placeholder 16x16
_RECORDS = {}


def _reduced_train(mesh_name="16x16", debug_mesh=None):
    key = (mesh_name, debug_mesh)
    if key not in _RECORDS:
        _RECORDS[key] = tdry.run_combo(
            "smollm_360m", "train_tiny", False,
            cfg_override=tbase.get_reduced("smollm_360m"), device="cpu",
            shape=tbase.InputShape("train_tiny", 64, 32, "train"),
            debug_mesh=debug_mesh)
    return _RECORDS[key]


def test_reduced_train_on_the_16x16_mesh():
    rec = _reduced_train()
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    one = _reduced_train("1x1", (1, 1))
    assert one["ok"] and one["collectives"] == {}
    # sharding never loses work: 256 ranks do at least the one rank's
    assert 256 * rec["flops"] >= one["flops"]
    # the gradients of weights replicated over 'data' are reduced there
    data = rec["collectives_by_axis"]["data"]
    assert data.get("all-reduce", {}).get("count", 0) \
        + data.get("reduce-scatter", {}).get("count", 0) > 0
    assert rec["collective_bytes"] == sum(
        v["bytes"] for v in rec["collectives"].values())
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] < one["memory"][
        "argument_size_in_bytes"]
    assert mem["alias_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert not dist.is_initialized()


def test_roofline_reads_a_port_record(tmp_path):
    sys.path.insert(0, ROOT)
    try:
        from benchmarks import roofline
    finally:
        sys.path.remove(ROOT)
    rec = _reduced_train()
    (tmp_path / "smollm_360m__train_tiny__16x16.json").write_text(
        json.dumps(rec))
    recs = roofline.load(str(tmp_path))
    assert len(recs) == 1
    t = roofline.terms(recs[0])
    assert t["compute_s"] > 0 and t["memory_s"] > 0 and t["collective_s"] > 0
    assert t["model_flops"] > 0 and t["hbm_used_gb"] > 0


# ------------------------------------------------------------- failures
def test_get_arch_failure_is_a_record():
    rec = tdry.run_combo("smollm_360m", "train_4k", False, device="cpu")
    assert rec["ok"] is False
    with pytest.raises(ValueError) as ref_err:
        jbase.get_arch("smollm_360m")
    assert rec["error"] == f"ValueError: {ref_err.value}"
    assert "traceback" in rec and rec["total_s"] >= 0
    assert not dist.is_initialized()


def test_main_exits_one_on_failure(tmp_path):
    with pytest.raises(SystemExit) as e:
        tdry.main(["--arch", "smollm_360m", "--shape", "decode_32k",
                   "--device", "cpu", "--out", str(tmp_path)])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "smollm_360m__decode_32k__16x16.json")
                     .read_text())
    assert rec["ok"] is False and rec["mode"] == "decode"


def test_placeholder_group_refuses_a_live_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already exists"):
            with placeholder_group(256):
                pass
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    with pytest.raises(ZeroDivisionError):
        with placeholder_group(4):
            1 / 0
    assert not dist.is_initialized()


def test_import_sets_nothing():
    code = ("import os, json; before = dict(os.environ); "
            "import repro_torch.launch.dryrun; "
            "import torch.distributed as d; "
            "print(json.dumps([dict(os.environ) == before, "
            "d.is_initialized()]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH="src"),
                         capture_output=True, text=True, check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == [True, False]


# ------------------------------------------------------------ the shim
def test_shim_returns_its_argument_without_a_mesh():
    x = torch.zeros(4, 8, 6)
    w = torch.zeros(6, 5)
    assert tlayers.current_mesh() is None
    assert tlayers.shard(x, tlayers.BATCH, None, "model") is x
    assert tlayers.wcol(w) is w
    assert tlayers.wrow(w) is w
    assert tlayers.shard_seq(x) is x
    assert tlayers.gather_seq(x) is x
    assert tlayers.whole_dim(x, 1) is x
    with placeholder_group(1):
        with tlayers.activation_mesh(make_debug_mesh(device="cpu")):
            # a plain tensor under an active mesh is left alone too
            assert tlayers.shard(x, tlayers.BATCH, None, None) is x
            assert tlayers.shard_seq(x) is x
            assert tlayers.wcol(w) is w
    assert tlayers.current_mesh() is None


def _on_mesh(tree, mesh):
    """Every tensor leaf of ``tree`` as a replicated DTensor of itself."""
    return tshd.distribute(tree, tree_map(
        lambda t: tshd.NamedSharding(mesh, tshd.P()), tree))


def test_dtensor_forms_give_the_plain_values():
    """On a 1x1 mesh over real tensors the DTensor branches (the masked-sum
    CE, the select cache write, the reshape helper) give the plain path's
    values: one train step and a decode step of reduced configs."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = tbase.get_reduced("smollm_360m")
    init_state, train_step = tsteps.make_train_step(cfg, "cpu")
    state = init_state(torch.Generator().manual_seed(0))
    batch = tpipe.synth_train_batch(cfg, tbase.InputShape("t", 32, 2,
                                                          "train"))
    _, plain = train_step(state, batch)
    mla = tbase.get_reduced("deepseek_v2_lite_16b")
    params = ttfm.init_lm(torch.Generator().manual_seed(0), mla, "cpu")
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    caches = ttfm.init_caches(mla, 2, 16, prefill_len=4, device="cpu")
    want_tok, want = ttfm.lm_decode_step(params, caches, mla, tok)
    with placeholder_group(1):
        mesh = make_debug_mesh(device="cpu")
        with tlayers.activation_mesh(mesh), implicit_replication():
            _, got = train_step(_on_mesh(state, mesh), _on_mesh(batch, mesh))
            caches = ttfm.init_caches(mla, 2, 16, prefill_len=4,
                                      device="cpu")
            got_tok, got_c = ttfm.lm_decode_step(
                _on_mesh(params, mesh), _on_mesh(caches, mesh), mla,
                _on_mesh(tok, mesh))
        for k in ("loss", "grad_norm"):
            torch.testing.assert_close(got[k].full_tensor(), plain[k],
                                       rtol=1e-6, atol=1e-6)
        assert torch.equal(got_tok.full_tensor(), want_tok)
        for a, b in zip(tree_leaves(got_c), tree_leaves(want)):
            torch.testing.assert_close(a.full_tensor(), b, rtol=0, atol=0)
    assert not dist.is_initialized()
