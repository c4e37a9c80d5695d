"""Port checkpoints and the prefetching sampler, on the CPU.

  * ``save`` / ``restore`` / ``cleanup`` (mirroring ``tests/test_infra.py``):
    bf16 as 16-bit patterns, the int step counter, loud errors on missing,
    truncated, garbled and mismatched files;
  * across packages: the reference restores what the port saves and the
    port restores what the reference saves (``AdamState(step, mu, nu)``,
    the error-feedback and fault sidecars), bitwise; the port's
    ``experiment.json`` reads back field for field; each package resumes
    the other's Trainer run;
  * save -> resume ``Trainer`` runs equal uninterrupted ones bitwise
    (mirroring ``tests/test_experiment_api.py``, ``test_round_engine.py``,
    ``test_compression.py`` and ``test_faults.py``);
  * ``PrefetchSampler``: the stream and ``rng_state_after`` bitwise the
    sequential sampler's, no generation refilled before release, worker
    errors raised in the consumer (mirroring ``test_round_engine.py``).
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentConfig as RefConfig
from repro.api import Trainer as RefTrainer
from repro.core import checkpoint as ref_ckpt
from repro.optim import optimizers as ref_opt
from repro_torch.api import CheckpointHook, ExperimentConfig, Trainer
from repro_torch.core import checkpoint, glasu
from repro_torch.graph import prefetch
from repro_torch.graph.prefetch import PrefetchSampler
from repro_torch.graph.sampler import GlasuSampler
from repro_torch.graph.synth import make_vfl_dataset
from repro_torch.optim import optimizers as opt
from repro_torch.tree import tree_leaves, tree_map

SIM_TOL = dict(rtol=2e-4, atol=2e-5)
TINY = dict(name="torch-ckpt", dataset="tiny", hidden=16, batch_size=8,
            size_cap=96, lr=0.05, eval_every=2)
COMPOSED = dict(faults={"seed": 5, "drop_prob": 0.3, "deadline_ms": 40.0,
                        "base_latency_ms": 5.0},
                compression={"method": "int8", "error_feedback": True})


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


def _data():
    return make_vfl_dataset("tiny", n_clients=3, seed=0)


# ---------------------------------------------------------- save / restore
def _tree():
    rng = np.random.default_rng(0)
    return {"w": torch.from_numpy(rng.normal(size=(4, 3)).astype(
                np.float32)).to(torch.bfloat16),
            "b": torch.arange(5, dtype=torch.int32),
            "nested": {"s": torch.tensor(3.5), "l": [torch.ones(2), None]},
            "state": opt.AdamState(7, torch.zeros(2), torch.ones(2))}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    checkpoint.save(str(tmp_path), 7, tree)
    assert checkpoint.latest_step(str(tmp_path)) == 7
    back = checkpoint.restore(str(tmp_path), tree)
    assert isinstance(back["state"], opt.AdamState) and back["state"].step == 7
    assert back["nested"]["l"][1] is None
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


def test_restore_errors_are_loud(tmp_path):
    tree = {"x": torch.arange(512, dtype=torch.float32)}
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        checkpoint.restore(str(tmp_path), tree)
    checkpoint.save(str(tmp_path), 1, tree)
    with pytest.raises(FileNotFoundError, match="comp"):
        checkpoint.restore(str(tmp_path), tree, name="comp")
    with pytest.raises(RuntimeError, match="leaves"):
        checkpoint.restore(str(tmp_path), {"x": tree["x"], "y": tree["x"]})
    with pytest.raises(RuntimeError, match="shape"):
        checkpoint.restore(str(tmp_path), {"x": torch.zeros(3)})
    for name in ("ckpt", "comp", "fault"):
        fn = tmp_path / checkpoint.save(str(tmp_path), 3, tree, name=name)
        raw = fn.read_bytes()
        fn.write_bytes(raw[:len(raw) // 2])
        with pytest.raises(RuntimeError, match="corrupt checkpoint"):
            checkpoint.restore(str(tmp_path), tree, step=3, name=name)
    fn = tmp_path / checkpoint.save(str(tmp_path), 4, tree)
    fn.write_bytes(b"\x89not-a-zip" * 64)
    with pytest.raises(RuntimeError, match="corrupt checkpoint"):
        checkpoint.restore(str(tmp_path), tree)


def test_checkpoint_cleanup(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in range(5):
        checkpoint.save(str(tmp_path), s, tree)
    checkpoint.cleanup(str(tmp_path), keep=2)
    assert len(list(tmp_path.glob("ckpt_*.npz"))) == 2
    assert checkpoint.latest_step(str(tmp_path)) == 4


def test_layout_crosses_packages_bitwise(tmp_path):
    """Each package restores the other's npz: sorted dict keys, NamedTuple
    order, bf16 bit patterns, the int32 step counter."""
    tree = _tree()
    checkpoint.save(str(tmp_path / "port"), 3, tree)
    like = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), {
        "w": jnp.zeros((4, 3), jnp.bfloat16),
        "b": jnp.zeros(5, jnp.int32),
        "nested": {"s": jnp.zeros((), jnp.float32),
                   "l": [jnp.zeros(2, jnp.float32), None]},
        "state": ref_opt.AdamState(jnp.zeros((), jnp.int32),
                                   jnp.zeros(2), jnp.zeros(2))})
    back = ref_ckpt.restore(str(tmp_path / "port"), like)
    assert back["w"].dtype == jnp.bfloat16 and int(back["state"].step) == 7
    for a, b in zip(tree_leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32)
                                      if np.asarray(b).dtype.name ==
                                      "bfloat16" else np.asarray(b))
    ref_ckpt.save(str(tmp_path / "ref"), 3, back)
    again = checkpoint.restore(str(tmp_path / "ref"), tree)
    _assert_trees_equal(again, tree)


# ------------------------------------------------------ trainer checkpoints
def _params_close(a, b, tol):
    for x, y in zip(tree_leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(_np(x), np.asarray(y), **tol)


def test_experiment_json_reads_back_in_the_reference(tmp_path):
    cfg = ExperimentConfig(**TINY, rounds=2, ckpt_dir=str(tmp_path),
                           serve={"max_batch": 8}, **COMPOSED)
    Trainer(cfg, data=_data(), device="cpu").run()
    blob = json.loads((tmp_path / "experiment.json").read_text())
    assert RefConfig.from_dict(blob).to_dict() == blob == cfg.to_dict()
    side = json.loads((tmp_path / "state_00000002.json").read_text())
    assert sorted(side) == ["comm_bytes", "elapsed_seconds", "fault_sched",
                            "history", "sampler_rng", "test_acc", "val_acc"]
    assert side["sampler_rng"]["bit_generator"] == "PCG64"


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_reference_resumes_the_port_run(tmp_path, optimizer):
    """The port trains 2 rounds (faults + int8 EF) into ckpt_dir; the
    reference resumes 2 -> 4 from it and lands where the port's
    uninterrupted 4-round run lands. The reference's restore target holds
    params, AdamState, EF accumulators and stale caches."""
    kw = dict(TINY, optimizer=optimizer, **COMPOSED)
    data = _data()
    Trainer(ExperimentConfig(**kw, rounds=2, ckpt_dir=str(tmp_path)),
            data=data, device="cpu").run()
    straight = Trainer(ExperimentConfig(**kw, rounds=4), data=data,
                       device="cpu").run()
    ref = RefTrainer(RefConfig(**kw, rounds=4, ckpt_dir=str(tmp_path)))
    res = ref.run()
    assert ref.sampler_restored and ref.fault_sched_restored
    assert res.comm_bytes == straight.comm_bytes
    assert [h["round"] for h in res.history] == [2, 4]
    assert res.history[0] == straight.history[0] | {
        "seconds": res.history[0]["seconds"]}
    if optimizer == "sgd":
        _params_close(straight.params, res.params, SIM_TOL)
    else:       # Adam's step-1 sign flips (tests/test_torch_train.py)
        _params_close(straight.params, res.params,
                      dict(rtol=0, atol=2 * 0.05 * 4))


def test_port_resumes_the_reference_run(tmp_path):
    kw = dict(TINY, optimizer="sgd", **COMPOSED)
    RefTrainer(RefConfig(**kw, rounds=2, ckpt_dir=str(tmp_path))).run()
    straight = RefTrainer(RefConfig(**kw, rounds=4)).run()
    t = Trainer(ExperimentConfig(**kw, rounds=4, ckpt_dir=str(tmp_path)),
                data=_data(), device="cpu")
    res = t.run()
    assert t.sampler_restored and t.fault_sched_restored
    assert res.comm_bytes == straight.comm_bytes
    assert [h["round"] for h in res.history] == [2, 4]
    _params_close(res.params, straight.params, SIM_TOL)
    # the reference's sidecars landed in the port's backend: the restored
    # carries are tensors of the right shapes
    assert all(isinstance(x, torch.Tensor)
               for x in tree_leaves(t.backend.comp_state)
               + tree_leaves(t.backend.fault_state))


def test_trainer_save_and_resume_bitwise(tmp_path):
    data = _data()
    cfg = ExperimentConfig(**TINY, rounds=2, ckpt_dir=str(tmp_path))
    assert Trainer(cfg, data=data, device="cpu").run().rounds_run == 2
    assert (tmp_path / "LATEST").read_text().strip() == "2"
    res = Trainer(cfg.with_(rounds=4), data=data, device="cpu").run()
    assert res.rounds_run == 4 and [h["round"] for h in res.history] == [2, 4]
    straight = Trainer(ExperimentConfig(**TINY, rounds=4), data=data,
                       device="cpu").run()
    _assert_trees_equal(res.params, straight.params)
    assert res.comm_bytes == straight.comm_bytes
    assert [h["loss"] for h in res.history] == \
        [h["loss"] for h in straight.history]
    with pytest.raises(ValueError, match="different experiment config"):
        Trainer(cfg.with_(rounds=6, hidden=32), data=data,
                device="cpu").run()


def test_resume_keeps_the_wall_clock_and_lands_on_the_final_round(tmp_path):
    data = _data()
    cfg = ExperimentConfig(**TINY, rounds=2, ckpt_dir=str(tmp_path))
    cfg = cfg.with_(eval_every=1)
    Trainer(cfg, data=data, device="cpu").run()
    again = Trainer(cfg, data=data, device="cpu").run()   # lands on 2
    assert again.rounds_run == 2 and [h["round"] for h in again.history] \
        == [1, 2]
    res = Trainer(cfg.with_(rounds=4), data=data, device="cpu").run()
    secs = [h["seconds"] for h in res.history]
    assert [h["round"] for h in res.history] == [1, 2, 3, 4]
    assert all(a <= b for a, b in zip(secs, secs[1:]))
    side = json.loads((tmp_path / "state_00000004.json").read_text())
    assert side["elapsed_seconds"] >= secs[-1] > 0.0


def test_resume_mid_step_bitwise(tmp_path):
    """ckpt_every cuts the K-grid; the resumed run equals a per-round one."""
    data = _data()
    cfg = ExperimentConfig(**TINY, rounds=3, rounds_per_step=2,
                           ckpt_dir=str(tmp_path), ckpt_every=3)
    Trainer(cfg, data=data, device="cpu").run()      # steps [2, 1]
    assert (tmp_path / "LATEST").read_text().strip() == "3"
    res = Trainer(cfg.with_(rounds=7), data=data, device="cpu").run()
    seq = Trainer(ExperimentConfig(**TINY, rounds=7), data=data,
                  device="cpu").run()
    _assert_trees_equal(res.params, seq.params)
    assert res.comm_bytes == seq.comm_bytes
    assert [h["round"] for h in res.history] == [2, 3, 4, 6, 7]


def test_sampler_state_skips_replay_and_old_sidecars_replay(tmp_path):
    data = _data()
    cfg = ExperimentConfig(**dict(TINY, eval_every=3), rounds=3,
                           ckpt_dir=str(tmp_path))
    Trainer(cfg, data=data, device="cpu").run()
    tr = Trainer(cfg.with_(rounds=5), data=data, device="cpu")
    calls = []
    orig = tr.sampler.sample_round
    tr.sampler.sample_round = lambda: calls.append(1) or orig()
    res = tr.run()
    assert tr.sampler_restored and len(calls) == 2
    seq = Trainer(cfg.with_(rounds=5, ckpt_dir=None), data=data,
                  device="cpu").run()
    _assert_trees_equal(res.params, seq.params)
    # a sidecar without the field replays the stream: same result
    sc = tmp_path / "state_00000005.json"
    legacy = json.loads(sc.read_text())
    legacy.pop("sampler_rng")
    sc.write_text(json.dumps(legacy))
    tr = Trainer(cfg.with_(rounds=7), data=data, device="cpu")
    calls.clear()
    orig = tr.sampler.sample_round
    tr.sampler.sample_round = lambda: calls.append(1) or orig()
    res = tr.run()
    assert not tr.sampler_restored and len(calls) == 7
    seq = Trainer(cfg.with_(rounds=7, ckpt_dir=None), data=data,
                  device="cpu").run()
    _assert_trees_equal(res.params, seq.params)


def test_extra_checkpoint_hook_cadence_cuts_steps(tmp_path):
    data = _data()
    cfg = ExperimentConfig(**TINY, rounds=5, rounds_per_step=4)
    Trainer(cfg.with_(eval_every=5), data=data, device="cpu",
            hooks=[CheckpointHook(str(tmp_path), every=3)]).run()
    side = json.loads((tmp_path / "state_00000003.json").read_text())
    ref = GlasuSampler(data, cfg.sampler_config(), seed=cfg.seed)
    for _ in range(3):
        ref.sample_round()
    assert side["sampler_rng"] == ref.rng.bit_generator.state


@pytest.mark.parametrize("extra", [
    dict(optimizer="adam", compression={"method": "topk_ef", "k": 2}),
    dict(compression={"method": "int8", "error_feedback": True}),
    dict(COMPOSED, rounds_per_step=2)])
def test_carries_resume_bitwise(tmp_path, extra):
    """EF accumulators (comp_<step>.npz), stale caches and the schedule
    state (fault_<step>.npz, the sidecar) restore bitwise: the resumed run
    reproduces the uninterrupted one exactly."""
    data = _data()
    base = ExperimentConfig(**dict(TINY, **extra), rounds=4)
    cfg = base.with_(ckpt_dir=str(tmp_path), ckpt_every=2, rounds=2)
    first = Trainer(cfg, data=data, device="cpu")
    first.run()
    assert (tmp_path / "comp_00000002.npz").exists()
    assert (tmp_path / "fault_00000002.npz").exists() == \
        ("faults" in extra)
    resumed = Trainer(cfg.with_(rounds=4), data=data, device="cpu")
    res = resumed.run()
    straight = Trainer(base, data=data, device="cpu")
    want = straight.run()
    _assert_trees_equal(res.params, want.params)
    _assert_trees_equal(resumed.backend.comp_state,
                        straight.backend.comp_state)
    _assert_trees_equal(resumed.backend.fault_state,
                        straight.backend.fault_state)
    assert res.comm_bytes == want.comm_bytes
    assert [h["loss"] for h in res.history] == \
        [h["loss"] for h in want.history]


def test_compression_is_resume_mutable_and_a_codec_change_resets(tmp_path):
    data = _data()
    base = ExperimentConfig(**TINY, rounds=2, ckpt_dir=str(tmp_path),
                            ckpt_every=2,
                            compression={"method": "topk_ef", "k": 2})
    t1 = Trainer(base, data=data, device="cpu")
    t1.run()
    assert any(float(v.abs().sum()) > 0
               for v in tree_leaves(t1.backend.comp_state))
    t2 = Trainer(base.with_(compression={"method": "int8",
                                         "error_feedback": True}),
                 data=data, device="cpu")
    t2.state.params = glasu.init_params(torch.Generator().manual_seed(0),
                                        t2.model_cfg, "cpu")
    t2.state.opt_state = t2.optimizer.init(t2.state.params)
    for h in t2.hooks:
        h.on_train_start(t2)             # resume to round 2, no new rounds
    assert t2.state.round == 2
    assert all(not v.any() for v in tree_leaves(t2.backend.comp_state))
    for rounds, cc in ((4, {"method": "int8", "error_feedback": True}),
                       (6, None), (8, {"method": "topk_ef", "k": 2})):
        res = Trainer(base.with_(rounds=rounds, compression=cc), data=data,
                      device="cpu").run()
        assert res.rounds_run == rounds


def test_corrupt_sidecar_with_matching_provenance_raises(tmp_path):
    data = _data()
    cfg = ExperimentConfig(**TINY, rounds=2, ckpt_dir=str(tmp_path),
                           **COMPOSED)
    Trainer(cfg, data=data, device="cpu").run()
    for name in ("comp", "fault"):
        fn = tmp_path / f"{name}_00000002.npz"
        good = fn.read_bytes()
        fn.write_bytes(good[:len(good) // 2])
        with pytest.raises(RuntimeError, match="corrupt checkpoint"):
            Trainer(cfg.with_(rounds=4), data=data, device="cpu").run()
        fn.write_bytes(good)


def test_orphaned_sidecars_are_pruned(tmp_path):
    data = _data()
    cfg = ExperimentConfig(**TINY, rounds=10, ckpt_dir=str(tmp_path),
                           ckpt_every=2, **COMPOSED)
    Trainer(cfg, data=data, device="cpu").run()
    steps = lambda pat: sorted(int(f.stem.split("_")[1])
                               for f in tmp_path.glob(pat))
    assert steps("ckpt_*.npz") == [6, 8, 10]
    for pat in ("state_*.json", "comp_*.npz", "fault_*.npz"):
        assert steps(pat) == [6, 8, 10]


# ------------------------------------------------------------- prefetch
def _sampler(seed=0):
    data = _data()
    cfg = ExperimentConfig(**TINY)
    return GlasuSampler(data, cfg.sampler_config(), seed=seed)


def test_prefetch_reproduces_the_sequential_stream():
    ref = _sampler(3)
    want = [prefetch.sample_rounds(ref, 1) for _ in range(5)]
    pf = PrefetchSampler(_sampler(3), [2, 2, 1], n_buffers=2)
    got, states = [], []
    try:
        for _ in range(3):
            step = pf.get()
            for i in range(step.rounds):
                got.append(prefetch.unstack_round(step.data, slice(i, i + 1)))
            states.append(step.rng_state_after)
            pf.retire(step)
    finally:
        pf.close()
    assert len(got) == 5
    for a, b in zip(got, want):
        for x, y in zip(tree_leaves(tuple(a)), tree_leaves(tuple(b))):
            assert x.dtype == torch.from_numpy(y).dtype
            np.testing.assert_array_equal(x.numpy(), y)
    assert states[-1] == ref.rng.bit_generator.state
    assert pf.stats()["rounds"] == 5 and pf.stats()["copy_ms"] is None


def test_prefetch_generation_not_reused_before_release():
    pf = PrefetchSampler(_sampler(), [1, 1, 1], n_buffers=2)
    try:
        s0 = pf.get()
        s1 = pf.get()                     # both generations filled
        assert s0.gen != s1.gen
        first = s0.data.labels.clone()
        host0 = pf._bufs[s0.gen].labels.clone()
        time.sleep(0.1)                   # a worker must not refill gen 0
        assert torch.equal(pf._bufs[s0.gen].labels, host0)
        pf.retire(s0)
        pf.retire(s1)                     # the pipeline is full: gen 0 free
        s2 = pf.get()
        assert s2.gen == s0.gen
        assert torch.equal(s0.data.labels, first)   # device copy untouched
        pf.retire(s2)
    finally:
        pf.close()


def test_prefetch_worker_errors_reach_the_consumer():
    sampler = _sampler()
    real = sampler.sample_round
    calls = []

    def failing_round():
        calls.append(1)
        if len(calls) > 1:
            time.sleep(0.2)               # the consumer blocks in get() first
            raise RuntimeError("boom mid-stream")
        return real()

    sampler.sample_round = failing_round
    pf = PrefetchSampler(sampler, [1, 1], n_buffers=1)
    try:
        pf.retire(pf.get())               # frees the generation: refill
        with pytest.raises(RuntimeError, match="prefetch worker failed"):
            pf.get()
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    # an error no get() delivered is raised by close()
    sampler.sample_round = lambda: (_ for _ in ()).throw(ValueError("x"))
    pf = PrefetchSampler(sampler, [1, 1], n_buffers=2)
    pf._thread.join(timeout=10.0)
    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetch_close_mid_fill_joins_promptly():
    sampler = _sampler()
    real = sampler.sample_round

    def slow_round():
        time.sleep(0.15)
        return real()

    sampler.sample_round = slow_round
    pf = PrefetchSampler(sampler, [40], n_buffers=1)
    time.sleep(0.4)                       # a few rounds into the fill
    t0 = time.monotonic()
    pf.close()
    assert not pf._thread.is_alive()
    assert time.monotonic() - t0 < 2.0    # a full fill is 6 s


def test_trainer_batches_come_from_the_prefetch_stream():
    """The Trainer's batches are the sampler's stream through the worker at
    one and two generations: the same parameters either way."""
    data = _data()
    runs = [Trainer(ExperimentConfig(**TINY, rounds=4, rounds_per_step=2,
                                     prefetch_buffers=n), data=data,
                    device="cpu") for n in (1, 2)]
    out = [t.run() for t in runs]
    _assert_trees_equal(out[0].params, out[1].params)
    for t in runs:
        assert t.prefetch_stats["rounds"] == 4


def test_tree_helpers_keep_named_tuples():
    state = opt.AdamState(3, {"a": torch.ones(2)}, {"a": torch.zeros(2)})
    doubled = tree_map(lambda x: x * 2 if isinstance(x, torch.Tensor)
                       else x, state)
    assert isinstance(doubled, opt.AdamState) and doubled.step == 3
    assert torch.equal(doubled.mu["a"], torch.full((2,), 2.0))
