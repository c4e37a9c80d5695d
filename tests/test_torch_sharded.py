"""Port parity for the client-sharded backend, on the CPU.

The port's sharded engine runs on a ``torch.distributed`` client mesh. Here
the mesh is one in-process gloo rank (m_loc = M, every gather a copy), as
the reference's mesh is one device on a CPU-only run, plus one row with 3
gloo ranks (one client each) spawned by ``torch.multiprocessing`` that
rendezvous through a ``FileStore`` under ``tmp_path``. Against the port's
vmapped backend (``SHARD_TOL``, the reference's class between the two
engines) and the live reference ``ShardedBackend`` from the same numpy
inputs and reference parameters:

  * the backbone × aggregation grid at K 1 and 4 rounds a step;
  * compressed (``COMP_TOL``), fault and composed rounds;
  * the bind-time collective audit against ``log_agg_traffic`` (and its
    refusal of a tampered codec), the client rules of ``launch``;
  * a checkpointed save -> resume, bitwise;
  * sharded serving against vmapped serving, with equal bills;
  * the one-rank group: every test closes what it built, and the last
    mesh closed destroys the group the mesh module built.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.api import ExperimentConfig as RefConfig
from repro.api import make_backend as ref_make_backend
from repro.core import glasu as ref_glasu
from repro.fed import faults as ref_faults
from repro.graph import sampler as ref_sampler
from repro.graph.prefetch import stack_rounds as ref_stack_rounds
from repro.graph.synth import make_vfl_dataset as ref_make_dataset
from repro.launch.mesh import client_mesh_size as ref_client_mesh_size
from repro_torch.api import ExperimentConfig, Hook, Trainer, make_backend
from repro_torch.api.backends import ShardedBackend
from repro_torch.core import checkpoint, glasu
from repro_torch.fed import faults, simulation
from repro_torch.graph import prefetch, sampler
from repro_torch.graph.synth import make_vfl_dataset
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.serve import InferenceSession
from repro_torch.tree import tree_leaves

import _torch_rank_worker

SHARD_TOL = dict(rtol=5e-5, atol=5e-5)
SIM_TOL = dict(rtol=2e-4, atol=2e-5)
COMP_TOL = dict(rtol=2e-4, atol=2e-4)
ROUNDS = 4
MODEL_GRID = [("gcn", "mean"), ("gcn", "concat"), ("gcnii", "mean"),
              ("gat", "mean")]
DEADLINE = dict(seed=5, drop_prob=0.3, deadline_ms=40.0, base_latency_ms=5.0)
INT8 = {"method": "int8", "error_feedback": True}


@pytest.fixture(autouse=True)
def _group_released():
    """A test leaves the process's default group as it found it: the
    backends, trainers and sessions it builds are closed, and the last mesh
    closed destroys the one-rank group built for them."""
    was = dist.is_initialized()
    yield
    assert dist.is_initialized() == was


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, **tol):
    a, b = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(_np(x), _np(y), **tol)


def _assert_ef_close(got, want):
    """Error-feedback carries at COMP_TOL except rare elements (<= 0.5 %)
    where fp32 noise straddles a wire rounding boundary: about one wire
    step, bounded by twice the carry's largest entry (as
    ``tests/test_torch_compression.py`` holds them)."""
    for x, y in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        g, w = _np(x), np.asarray(y)
        bad = ~np.isclose(g, w, **COMP_TOL)
        assert bad.mean() <= 0.005, f"{bad.sum()} of {bad.size} off"
        assert np.all(np.abs(g - w)[bad] <= 2 * np.abs(w).max() + 2e-4)


def _kw(backbone, agg, **extra):
    kw = dict(name=f"torch-shard-{backbone}-{agg}", dataset="tiny",
              backbone=backbone, agg=agg, hidden=16, batch_size=8,
              size_cap=96, rounds=ROUNDS, eval_every=ROUNDS, lr=0.05,
              optimizer="sgd", n_local_steps=2)
    kw.update(extra)
    return kw


def _world(kw):
    rcfg, tcfg = RefConfig(**kw), ExperimentConfig(**kw)
    rdata, tdata = ref_make_dataset("tiny"), make_vfl_dataset("tiny")
    rm, tm = rcfg.glasu_config(rdata), tcfg.glasu_config(tdata)
    rs = ref_sampler.GlasuSampler(rdata, rcfg.sampler_config(), seed=0)
    ts = sampler.GlasuSampler(tdata, tcfg.sampler_config(), seed=0)
    params = jax.device_get(ref_glasu.init_params(jax.random.PRNGKey(0), rm))
    rounds = [jax.tree.map(np.array, rs.sample_round())
              for _ in range(ROUNDS)]
    return dict(rcfg=rcfg, tcfg=tcfg, rm=rm, tm=tm, rs=rs, ts=ts,
                params=params, rounds=rounds)


def _plans(fc, n):
    if fc is None:
        return None, None
    return (ref_faults.FaultSchedule(ref_faults.FaultConfig(**fc),
                                     3).draw_step(n),
            faults.FaultSchedule(faults.FaultConfig(**fc), 3).draw_step(n))


def _run_port(w, name, k, fc=None):
    """ROUNDS rounds through the port's backend ``name`` in steps of k."""
    _, plans = _plans(fc, ROUNDS)
    opt = w["tcfg"].make_optimizer()
    be = make_backend(name, **({"device": "cpu"} if name == "sharded"
                               else {}))
    be.bind(w["tm"], opt, w["ts"])
    p = checkpoint.params_from_numpy(w["params"], "cpu")
    s = opt.init(p)
    losses, nbytes = [], []
    for t in range(0, ROUNDS, k):
        stack = sampler.batch_to_device(
            prefetch.stack_rounds(w["rounds"][t:t + k]), "cpu")
        kw = {} if plans is None else {"faults": plans[t:t + k]}
        out = be.run_step(p, s, stack, **kw)
        p, s = out.params, out.opt_state
        losses.append(_np(out.losses))
        nbytes += list(out.comm_bytes_rounds) if plans is not None \
            else [out.comm_bytes_round] * k
    return p, np.concatenate(losses), nbytes, be


@functools.lru_cache(maxsize=None)
def _run_ref_cached(kw_json):
    """The reference ShardedBackend, one round a step (its K-round scan
    runs the same rounds), once per configuration."""
    kw = json.loads(kw_json)
    w = _world(kw)
    plans, _ = _plans(kw.get("faults"), ROUNDS)
    opt = w["rcfg"].make_optimizer()
    be = ref_make_backend("sharded")
    be.bind(w["rm"], opt, w["rs"])
    p = jax.tree.map(jnp.asarray, w["params"])
    s = opt.init(p)
    losses, nbytes = [], []
    for t in range(ROUNDS):
        stack = jax.tree.map(jnp.asarray,
                             ref_stack_rounds(w["rounds"][t:t + 1]))
        keys = jnp.stack([jax.random.PRNGKey(t)])
        extra = {} if plans is None else {"faults": plans[t:t + 1]}
        out = be.run_step(p, s, stack, keys, **extra)
        p, s = out.params, out.opt_state
        losses.append(np.asarray(out.losses))
        nbytes += list(out.comm_bytes_rounds) if plans is not None \
            else [out.comm_bytes_round]
    return (jax.device_get(p), np.concatenate(losses), nbytes,
            be.collectives, jax.device_get(be.comp_state),
            jax.device_get(be.fault_state))


def _ref(kw):
    return _run_ref_cached(json.dumps(kw, sort_keys=True))


# ------------------------------------------------------------------ mesh
def test_client_mesh_size_and_one_rank_mesh():
    for m in range(1, 9):
        for d in range(1, 9):
            assert mesh_lib.client_mesh_size(m, d) == \
                ref_client_mesh_size(m, d)
    with pytest.raises(ValueError, match="positive"):
        mesh_lib.client_mesh_size(0, 4)
    mesh = mesh_lib.make_client_mesh(3, device="cpu")
    assert (mesh.size, mesh.rank, mesh.m_loc, mesh.i0, mesh.n_clients) == \
        (1, 0, 3, 0, 3)
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="max_devices"):
        mesh_lib.make_client_mesh(3, max_devices=0, device="cpu")
    # the gather carries every dtype of a wire payload, byte for byte
    for x in (torch.arange(12.0).reshape(3, 4),
              torch.arange(12, dtype=torch.int16).reshape(3, 2, 2),
              torch.linspace(-2, 2, 12).to(torch.float8_e4m3fn).reshape(3, 4),
              torch.linspace(-2, 2, 12).half().reshape(3, 4, 1)):
        y = mesh.gather(x)
        assert y.dtype == x.dtype and torch.equal(y.view(torch.uint8),
                                                  x.view(torch.uint8))
    mesh.close()


def test_one_rank_group_lives_until_its_last_mesh_closes():
    """The one-rank group ``make_client_mesh`` builds is shared by the
    meshes built on it, whatever holds them (a mesh, a backend, a Trainer,
    a session), and the last one closed destroys it; a group the caller
    initialized is never destroyed by a mesh."""
    assert not dist.is_initialized()    # no earlier test left a group
    w = _world(_kw("gcn", "mean"))
    mesh = mesh_lib.make_client_mesh(3, device="cpu")
    sb = make_backend("sharded", device="cpu")
    sb.bind(w["tm"], w["tcfg"].make_optimizer(), w["ts"])
    trainer = Trainer(w["tcfg"].with_(backend="sharded"), device="cpu")
    sess = InferenceSession(
        checkpoint.params_from_numpy(w["params"], "cpu"), w["tcfg"],
        make_vfl_dataset("tiny"), device="cpu", serve={"engine": "sharded"})
    assert mesh.owns_group and sb.mesh.owns_group
    for holder in (sess, sb, mesh):
        holder.close()
        holder.close()                  # twice is a no-op
        assert dist.is_initialized()
    trainer.close()
    assert not dist.is_initialized()
    # the process may now own its default group; a mesh leaves it alone
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mine = mesh_lib.make_client_mesh(3, device="cpu")
        assert not mine.owns_group
        mine.close()
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


def test_client_rules_take_and_gather_blocks():
    mesh = mesh_lib.make_client_mesh(3, device="cpu")
    w = _world(_kw("gcn", "mean"))
    params = checkpoint.params_from_numpy(w["params"], "cpu")
    specs = shd.client_param_specs(params, mesh)
    assert {s.dim for s in tree_leaves(specs)} == {0}
    back = shd.gather_block(shd.local_block(params, specs, mesh), specs,
                            mesh)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)
    opt = w["tcfg"].make_optimizer()
    ospecs = shd.client_param_specs(opt.init(params), mesh)
    assert ospecs.step == shd.REPLICATED
    stack = sampler.batch_to_device(prefetch.stack_rounds(w["rounds"][:2]),
                                    "cpu")
    bspecs = shd.client_batch_specs(stack, mesh, round_stacked=True)
    assert bspecs.feats.dim == 1 and bspecs.labels == shd.REPLICATED
    cs = glasu.init_comp_state(ExperimentConfig(**_kw(
        "gcn", "mean", compression=INT8)).glasu_config(make_vfl_dataset(
            "tiny")), w["ts"].layer_sizes)
    cspecs = shd.client_comp_state_specs(cs, mesh)
    assert all(v["up"].dim == 0 and v["down"] == shd.REPLICATED
               for v in cspecs.values())
    fs = {1: torch.zeros(3, 5, 16)}
    assert shd.client_fault_state_specs(fs, mesh)[1].dim == 0
    assert shd.client_fault_state_specs(fs, mesh, replicated=True)[1] == \
        shd.REPLICATED
    # a leaf whose client axis does not split stays replicated (guarded)
    two = mesh_lib.ClientMesh(size=2, rank=0, m_loc=1, group=None,
                              device=torch.device("cpu"))
    assert shd.client_leaf_spec(torch.zeros(3, 4), two) == shd.REPLICATED
    mesh.close()


# ------------------------------------------------------------------ grid
@pytest.mark.parametrize("k", [1, ROUNDS])
@pytest.mark.parametrize("backbone,agg", MODEL_GRID)
def test_sharded_grid_matches_vmapped_and_reference(backbone, agg, k):
    kw = _kw(backbone, agg)
    w = _world(kw)
    vp, vl, vbytes, _ = _run_port(w, "vmapped", k)
    sp, sl, sbytes, sb = _run_port(w, "sharded", k)
    assert sbytes == vbytes == [w["ts"].comm_bytes_per_joint_inference(
        16, agg)] * ROUNDS
    np.testing.assert_allclose(sl, vl, **SHARD_TOL)
    _close(sp, vp, **SHARD_TOL)
    rp, rl, rbytes, rcoll, _, _ = _ref(kw)
    assert sbytes == rbytes
    assert [tuple(c) for c in sb.collectives] == [tuple(c) for c in rcoll]
    np.testing.assert_allclose(sl, rl, **SIM_TOL)
    _close(sp, rp, **SIM_TOL)
    batch = sampler.batch_to_device(w["rounds"][0], "cpu")
    np.testing.assert_allclose(
        _np(sb.joint_logits(sp, batch)),
        _np(glasu.joint_inference(sp, batch, w["tm"])[0]), **SHARD_TOL)
    sb.close()


@pytest.mark.parametrize("case", ["int8", "fp8", "topk", "deadline",
                                  "deadline+int8"])
def test_sharded_compressed_and_fault_rounds(case):
    comp = {"int8": INT8, "fp8": {"method": "fp8"},
            "topk": {"method": "topk_ef", "k": 2},
            "deadline+int8": INT8}.get(case)
    fc = DEADLINE if case.startswith("deadline") else None
    kw = _kw("gcn", "mean", compression=comp, faults=fc)
    w = _world(kw)
    vp, vl, vbytes, vb = _run_port(w, "vmapped", 2, fc)
    sp, sl, sbytes, sb = _run_port(w, "sharded", 2, fc)
    assert sbytes == vbytes
    if fc is not None:
        assert min(vbytes) < max(vbytes)    # someone's upload went missing
    tol = SHARD_TOL if comp is None else COMP_TOL
    np.testing.assert_allclose(sl, vl, **tol)
    _close(sp, vp, **tol)
    _close(sb.comp_state, vb.comp_state, **tol)
    _close(sb.fault_state, vb.fault_state, **tol)
    rp, rl, rbytes, rcoll, rcs, rfs = _ref(kw)
    assert sbytes == rbytes
    assert [tuple(c) for c in sb.collectives] == [tuple(c) for c in rcoll]
    np.testing.assert_allclose(sl, rl, **(SIM_TOL if comp is None
                                           else COMP_TOL))
    _close(sp, rp, **(SIM_TOL if comp is None else COMP_TOL))
    if rcs:
        _assert_ef_close(sb.comp_state, rcs)
    if rfs is not None:
        _close(sb.fault_state, rfs, **(SIM_TOL if comp is None
                                       else COMP_TOL))
    sb.close()


def test_sharded_privacy_hooks_match_vmapped():
    """Every rank seeds its generator alike, so secure-aggregation masks
    and DP noise are the vmapped engine's."""
    kw = _kw("gcnii", "mean", secure_agg=True, dp_sigma=0.01,
             optimizer="adam")
    w = _world(kw)
    opt = w["tcfg"].make_optimizer()
    out = {}
    for name in ("vmapped", "sharded"):
        be = make_backend(name, **({"device": "cpu"} if name == "sharded"
                                   else {}))
        be.bind(w["tm"], opt, w["ts"])
        p = checkpoint.params_from_numpy(w["params"], "cpu")
        s = opt.init(p)
        for t in range(2):
            gen = torch.Generator().manual_seed(100 + t)
            o = be.run_round(p, s, sampler.batch_to_device(w["rounds"][t],
                                                           "cpu"), gen)
            p, s = o.params, o.opt_state
        out[name] = (p, o.losses)
        be.close()
    np.testing.assert_allclose(_np(out["sharded"][1]), _np(out["vmapped"][1]),
                               **SHARD_TOL)
    _close(out["sharded"][0], out["vmapped"][0], **SHARD_TOL)


# ------------------------------------------------------------- the audit
@pytest.mark.parametrize("agg,comp", [("mean", None), ("concat", None),
                                      ("mean", INT8),
                                      ("mean", {"method": "topk_ef", "k": 3})])
def test_bind_audit_matches_the_message_log(agg, comp):
    w = _world(_kw("gcn", agg, compression=comp))
    sb = make_backend("sharded", device="cpu")
    sb.bind(w["tm"], w["tcfg"].make_optimizer(), w["ts"])
    shell = w["ts"].shape_shell_batch()
    log = simulation.MessageLog()
    simulation.log_agg_traffic(log, shell, w["tm"], compressor=sb.compressor)
    assert sum(r.star_bytes() for r in sb.collectives) == log.total_bytes()
    assert [r.layer for r in sb.collectives] == list(w["tm"].agg_layers)
    assert sb.bytes_per_round == w["ts"].comm_bytes_per_joint_inference(
        16, agg, compressor=sb.compressor)
    if sb.comp_state:               # the throwaway audit left the carry alone
        assert all(float(v.abs().max()) == 0
                   for v in tree_leaves(sb.comp_state))
    sb.close()


def test_bind_audit_raises_on_a_tampered_codec(monkeypatch):
    w = _world(_kw("gcn", "mean", compression=INT8))
    from repro_torch.comm import compression
    wire = compression.Int8Quantizer.wire_bytes
    monkeypatch.setattr(compression.Int8Quantizer, "wire_bytes",
                        lambda self, n, d: wire(self, n, d) + 1)
    with pytest.raises(RuntimeError, match="collective byte-meter audit"):
        make_backend("sharded", device="cpu").bind(
            w["tm"], w["tcfg"].make_optimizer(), w["ts"])
    # the failed bind released its mesh (the fixture checks the group)


def test_sharded_refusals():
    w = _world(_kw("gcn", "mean"))
    cfg = ExperimentConfig(**_kw("gcn", "mean", labels_at_client=0))
    with pytest.raises(ValueError, match="labels_at_client"):
        make_backend("sharded", device="cpu").bind(
            cfg.glasu_config(make_vfl_dataset("tiny")),
            w["tcfg"].make_optimizer(), w["ts"])
    for bad, match in ((dict(labels_at_client=0), "labels_at_client"),
                       (dict(optimizer="adafactor"), "adafactor")):
        with pytest.raises(ValueError, match=match):
            ExperimentConfig(dataset="tiny", backend="sharded", **bad)
    with pytest.raises(ValueError, match="mesh_devices"):
        ExperimentConfig(dataset="tiny", mesh_devices=1)
    sb = make_backend("sharded", device="cpu")
    sb.bind(w["tm"], w["tcfg"].make_optimizer(), w["ts"])
    p = checkpoint.params_from_numpy(w["params"], "cpu")
    ada = w["tcfg"].with_(optimizer="adafactor").make_optimizer()
    with pytest.raises(ValueError, match="adafactor"):
        sb.round_fn(p, ada.init(p), sampler.batch_to_device(
            w["rounds"][0], "cpu"))
    sb.close()
    wrong = mesh_lib.ClientMesh(size=1, rank=0, m_loc=2, group=None,
                                device=torch.device("cpu"))
    for build in (glasu.make_round_fn, glasu.make_multi_round_fn):
        with pytest.raises(ValueError, match="n_clients=3"):
            build(w["tm"], w["tcfg"].make_optimizer(), mesh=wrong)
    trainer = Trainer(w["tcfg"].with_(backend="sharded", mesh_devices=1),
                      device="cpu")
    assert isinstance(trainer.backend, ShardedBackend)
    assert trainer.backend._mesh_devices == 1
    assert trainer.backend.mesh.size == 1
    trainer.close()


# ------------------------------------------------------------- checkpoint
class _Inject(Hook):
    def __init__(self, params):
        self.params = params

    def on_train_start(self, trainer):
        if trainer.state.round:
            return                              # resumed: keep the restore
        trainer.state.params = checkpoint.params_from_numpy(self.params,
                                                            "cpu")
        trainer.state.opt_state = trainer.optimizer.init(trainer.state.params)


def test_sharded_save_resume_is_bitwise(tmp_path):
    kw = _kw("gcnii", "mean", optimizer="adam", rounds=6, eval_every=2,
             backend="sharded", faults=DEADLINE, compression=INT8)
    w = _world(kw)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = w["tcfg"].with_(ckpt_dir=str(tmp_path / "ck"), ckpt_every=2)
        first = Trainer(cfg.with_(rounds=4), hooks=[_Inject(w["params"])],
                        device="cpu")
        first.run()
        first.close()
        resumed_trainer = Trainer(cfg, hooks=[_Inject(w["params"])],
                                  device="cpu")
        resumed = resumed_trainer.run()
        resumed_trainer.close()
        assert resumed_trainer.sampler_restored
        assert resumed_trainer.fault_sched_restored
        whole_trainer = Trainer(w["tcfg"], hooks=[_Inject(w["params"])],
                                device="cpu")
        whole = whole_trainer.run()
        whole_trainer.close()
        assert resumed.comm_bytes == whole.comm_bytes
        for a, b in zip(tree_leaves(resumed.params),
                        tree_leaves(whole.params)):
            assert torch.equal(a, b)
        assert [e["round"] for e in resumed.history] == [2, 4, 6]
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("comp", [None, INT8])
def test_sharded_serving_matches_vmapped(comp):
    kw = dict(dataset="tiny", hidden=16, batch_size=8, size_cap=96,
              compression=comp, backend="sharded")
    cfg = ExperimentConfig(**kw)
    data = make_vfl_dataset("tiny")
    params = glasu.init_params(torch.Generator().manual_seed(0),
                               cfg.glasu_config(data), "cpu")
    q = np.random.default_rng(0).choice(data.n_nodes, size=6, replace=False)
    answers = {}
    for engine in ("vmapped", "sharded"):
        sess = InferenceSession(params, cfg, data, device="cpu",
                                serve={"engine": engine, "max_batch": 8,
                                       "record_log": True})
        answers[engine] = (sess.answer(q), sess.answer(q),
                           sess.answer(q[:3]))
        sess.close()
    for a, b in zip(answers["sharded"], answers["vmapped"]):
        np.testing.assert_allclose(a.per_client, b.per_client, **SHARD_TOL)
        np.testing.assert_allclose(a.logits, b.logits, **SHARD_TOL)
        assert (a.upload_bytes, a.broadcast_bytes, a.index_bytes,
                a.fresh_rows, a.cold) == (b.upload_bytes, b.broadcast_bytes,
                                          b.index_bytes, b.fresh_rows,
                                          b.cold)
        assert a.log.total_bytes() == a.wire_bytes
    assert answers["sharded"][0].cold and not answers["sharded"][1].cold


# ------------------------------------------------------------ gloo ranks
def _spawn_ranks(world, tmp_path, cfg_kw):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_torch_rank_worker.run_rank,
                         args=(r, world, str(tmp_path / "store"), cfg_kw,
                               str(tmp_path / f"ck{world}"), queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = sorted((queue.get(timeout=120) for _ in procs),
                     key=lambda d: d["rank"])
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    return got, [p.exitcode for p in procs]


@pytest.mark.parametrize("world", [3, 2])
def test_three_gloo_ranks_match_one_rank(tmp_path, world):
    """3 gloo ranks, one client each (M 3, m_loc 1): every rank's gathered
    parameters match the one-rank run at SHARD_TOL, the bytes and the
    collective records are equal, and only rank 0 writes checkpoints. With
    2 ranks the mesh takes 1 (the largest divisor of 3 that fits) and the
    second rank raises at bind instead of idling."""
    cfg_kw = _kw("gcn", "concat", rounds_per_step=2, eval_every=2,
                 ckpt_every=2)
    got, codes = _spawn_ranks(world, tmp_path, cfg_kw)
    if world == 2:
        assert "outside the client mesh" in got[1]["error"]
        assert codes[1] != 0
        got = got[:1]
    for g in got:
        assert "error" not in g, g.get("error")
    one = Trainer(ExperimentConfig(backend="sharded",
                                   ckpt_dir=str(tmp_path / "ck1"), **cfg_kw),
                  device="cpu")
    want = one.run()
    one.close()
    d = 3 if world == 3 else 1
    assert [(g["size"], g["m_loc"], g["i0"]) for g in got] == \
        [(d, 3 // d, r * (3 // d)) for r in range(d)]
    for g in got:
        assert g["comm_bytes"] == want.comm_bytes
        assert g["collectives"] == one.backend.collectives
        np.testing.assert_allclose(g["losses"],
                                   [e["loss"] for e in want.history],
                                   **SHARD_TOL)
        for a, b in zip(g["params"], tree_leaves(want.params)):
            np.testing.assert_allclose(a, b.numpy(), **SHARD_TOL)
    assert sorted(os.listdir(tmp_path / f"ck{world}")) == \
        sorted(os.listdir(tmp_path / "ck1"))
