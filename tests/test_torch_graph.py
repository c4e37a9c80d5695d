"""Port parity: host graph data and evaluation tables, bitwise.

``repro_torch``'s numpy modules (datasets, CSR, padded neighbor tables,
eval tables, the power-law profiles and their streamed feature store) must
reproduce ``repro``'s exactly, including how the generators' draws are
consumed — every later parity test stands on them. A few ``Trainer``
rounds on the streamed ``powerlaw-tiny`` profile go against the
reference's at its own round tolerance.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.api import ExperimentConfig as RefConfig
from repro.api import Trainer as RefTrainer
from repro.core import glasu as ref_glasu
from repro.core import train as ref_train
from repro.graph import feature_store as ref_store
from repro.graph import graph as ref_graph
from repro.graph import synth as ref_synth
from repro_torch.api import ExperimentConfig, Hook, Trainer
from repro_torch.core import checkpoint
from repro_torch.core import train as pt_train
from repro_torch.graph import feature_store as pt_store
from repro_torch.graph import graph as pt_graph
from repro_torch.graph import synth as pt_synth
from repro_torch.tree import tree_leaves

SIM_TOL = dict(rtol=2e-4, atol=2e-5)


def _assert_graph_equal(a, b):
    assert a.n_nodes == b.n_nodes
    for field in ("indptr", "indices", "features", "labels", "train_idx",
                  "val_idx", "test_idx"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


# a small HeriGraph-style spec: exercises the natural-subgraph branch at a
# fraction of the real profiles' edge counts
NATURAL = dict(n_nodes=300, avg_deg=24.0, feat_dim=20, n_classes=5,
               natural_subgraphs=True, feat_noise=3.0)


@pytest.mark.parametrize("name,n_clients,seed,spec", [
    ("tiny", 3, 0, None), ("tiny", 2, 5, None), ("cora", 3, 0, None),
    ("natural", 3, 1, NATURAL), ("pubmed", 3, 0, None),
    ("citeseer", 3, 0, None), ("reddit", 3, 0, None), ("suzhou", 3, 0, None),
    ("venice", 2, 1, None), ("amsterdam", 3, 0, None)])
def test_make_vfl_dataset_bitwise(name, n_clients, seed, spec):
    kw = {}
    if spec is not None:
        kw = dict(spec=ref_synth.DatasetSpec(**spec))
    want = ref_synth.make_vfl_dataset(name, n_clients=n_clients, seed=seed,
                                      **kw)
    if spec is not None:
        kw = dict(spec=pt_synth.DatasetSpec(**spec))
    got = pt_synth.make_vfl_dataset(name, n_clients=n_clients, seed=seed,
                                    **kw)
    assert got.name == want.name and got.n_classes == want.n_classes
    assert got.n_clients == want.n_clients
    for a, b in zip(got.clients, want.clients):
        _assert_graph_equal(a, b)
    _assert_graph_equal(got.full, want.full)


def test_specs_match_reference():
    assert pt_synth.SPECS.keys() == ref_synth.SPECS.keys()
    for name, spec in pt_synth.SPECS.items():
        assert vars(spec) == vars(ref_synth.SPECS[name]), name


@pytest.mark.parametrize("name,cap,seed", [
    ("tiny", 32, 0), ("tiny", 3, 7), ("cora", 32, 0), ("cora", 2, 3)])
def test_eval_tables_bitwise(name, cap, seed):
    data_ref = ref_synth.make_vfl_dataset(name)
    data_pt = pt_synth.make_vfl_dataset(name)
    want = ref_train._eval_tables(data_ref, cap, seed)
    got = pt_train._eval_tables(data_pt, cap, seed)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    idx, mask = pt_train._eval_neighbor_tables(data_pt, cap, seed)
    np.testing.assert_array_equal(idx, np.asarray(want[1]))
    np.testing.assert_array_equal(mask, np.asarray(want[2]))


@pytest.mark.parametrize("max_deg,include_self", [(2, True), (5, False),
                                                  (64, True)])
def test_padded_neighbor_table_bitwise(max_deg, include_self):
    """Hub rows (degree > cap) take the generator path; rng state after the
    call must agree too, so chained draws stay aligned."""
    rng = np.random.default_rng(11)
    edges = rng.integers(0, 300, size=(2400, 2)).astype(np.int32)
    indptr, indices = pt_graph.edges_to_csr(300, edges)
    r_indptr, r_indices = ref_graph.edges_to_csr(300, edges)
    np.testing.assert_array_equal(indptr, r_indptr)
    np.testing.assert_array_equal(indices, r_indices)
    feats = np.zeros((300, 4), np.float32)
    labels = np.zeros(300, np.int32)
    split = np.arange(300)
    g = pt_graph.Graph(300, indptr, indices, feats, labels, split, split, split)
    r = ref_graph.Graph(300, r_indptr, r_indices, feats, labels, split, split,
                        split)
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    got = g.padded_neighbor_table(max_deg, rng_a, include_self=include_self)
    want = r.padded_neighbor_table(max_deg, rng_b, include_self=include_self)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert rng_a.random() == rng_b.random()


def _edge_list(case, n, seed):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(4 * n, 2)).astype(np.int32)
    if case == "duplicates":
        e = np.concatenate([e, e[: n], e[: n // 2]])
    elif case == "reversed":
        e = np.concatenate([e, e[:, ::-1]])
    elif case == "self_loops":
        loops = rng.integers(0, n, size=n // 3).astype(np.int32)
        e = np.concatenate([e, np.stack([loops, loops], 1)])
    elif case == "all_three":
        e = np.concatenate([e, e[::-1], e[: n, ::-1],
                            np.stack([e[:, 0], e[:, 0]], 1)])
        e = e[rng.permutation(len(e))]
    elif case == "only_self_loops":
        e = np.stack([e[:, 0], e[:, 0]], 1)
    elif case == "int64_one_edge":
        e = np.array([[n - 1, 0]], np.int64)  # glint: disable=GL003 an int64 edge list, as a caller may pass one; host-only
    return np.ascontiguousarray(e)


@pytest.mark.parametrize("case,n,seed", [
    ("duplicates", 300, 0), ("reversed", 1000, 1), ("self_loops", 257, 2),
    ("all_three", 3000, 3), ("only_self_loops", 50, 4),
    ("int64_one_edge", 9, 5)])
def test_edges_to_csr_bitwise(case, n, seed):
    """The port's key sort gives the reference's CSR bit for bit: every
    pair once in both directions, no self loops, rows and columns
    ascending."""
    edges = _edge_list(case, n, seed)
    got = pt_graph.edges_to_csr(n, edges)
    want = ref_graph.edges_to_csr(n, edges)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bad", [[[0, 5]], [[-1, 2]]])
def test_edges_to_csr_refuses_ids_outside_the_graph(bad):
    with pytest.raises(ValueError):
        pt_graph.edges_to_csr(5, np.array(bad, np.int32))


def test_edges_to_csr_empty():
    indptr, indices = pt_graph.edges_to_csr(5, np.zeros((0, 2), np.int32))
    r_indptr, r_indices = ref_graph.edges_to_csr(5, np.zeros((0, 2), np.int32))
    np.testing.assert_array_equal(indptr, r_indptr)
    assert indices.shape == r_indices.shape == (0,)


def test_centralized_view():
    data = pt_synth.make_vfl_dataset("tiny")
    cent = pt_train.make_centralized_dataset(data)
    assert cent.n_clients == 1 and cent.clients[0] is data.full
    assert cent.name == "tiny-centralized"


# ----------------------------------------------------- power-law profiles
def test_powerlaw_specs_match_reference():
    assert pt_synth.POWERLAW_SPECS.keys() == ref_synth.POWERLAW_SPECS.keys()
    for name, spec in pt_synth.POWERLAW_SPECS.items():
        assert vars(spec) == vars(ref_synth.POWERLAW_SPECS[name]), name


@pytest.mark.parametrize("n_clients,seed", [(2, 0), (3, 5)])
def test_powerlaw_tiny_bitwise(tmp_path, n_clients, seed):
    """Labels, every client's CSR, the splits and the feature file's bytes;
    ``make_vfl_dataset`` routes the profile as the reference does."""
    want = ref_synth.make_powerlaw_dataset(
        "powerlaw-tiny", n_clients=n_clients, seed=seed,
        root=str(tmp_path / "ref"))
    got = pt_synth.make_powerlaw_dataset(
        "powerlaw-tiny", n_clients=n_clients, seed=seed,
        root=str(tmp_path / "pt"))
    assert got.name == want.name and got.n_clients == n_clients
    for a, b in zip(got.clients + [got.full], want.clients + [want.full]):
        assert a.n_nodes == b.n_nodes
        for field in ("indptr", "indices", "labels", "train_idx", "val_idx",
                      "test_idx"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype, field
            np.testing.assert_array_equal(x, y, err_msg=field)
        assert pt_store.is_streamed(a.features)
        assert a.features.shape == b.features.shape
        assert a.features._cols == b.features._cols
    with open(got.full.features.path, "rb") as f, \
            open(want.full.features.path, "rb") as g:
        assert f.read() == g.read()
    routed = pt_synth.make_vfl_dataset("powerlaw-tiny", n_clients=n_clients,
                                       seed=seed)
    np.testing.assert_array_equal(routed.full.indices, want.full.indices)
    with open(routed.full.features.path, "rb") as f, \
            open(want.full.features.path, "rb") as g:
        assert f.read() == g.read()
    os.remove(routed.full.features.path)
    os.rmdir(os.path.dirname(routed.full.features.path))


def _write_store(path, n, d, seed):
    mm = pt_store.create_store(path, n, d)
    mm[:] = np.random.default_rng(seed).normal(size=(n, d)).astype(
        np.float32)
    mm.flush()
    del mm
    return np.load(path)


@pytest.mark.parametrize("chunk_rows,cache_chunks", [(3, 2), (40, 3),
                                                     (512, 1)])
def test_feature_store_gather_bitwise(tmp_path, chunk_rows, cache_chunks):
    path = str(tmp_path / "store.npy")
    full = _write_store(path, 257, 6, chunk_rows)
    got = pt_store.MemmapFeatureStore(path, chunk_rows=chunk_rows,
                                      cache_chunks=cache_chunks)
    want = ref_store.MemmapFeatureStore(path, chunk_rows=chunk_rows,
                                        cache_chunks=cache_chunks)
    rows = np.random.default_rng(1).integers(0, 257, size=60)
    for q in (rows, rows[::-1], rows.reshape(12, 5), int(rows[0])):
        a, b = got[q], want[q]
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, full[q])
    view = got.view(2, 5)
    assert view.path == got.path and view.shape == (257, 3)
    np.testing.assert_array_equal(view[rows], full[rows, 2:5])
    np.testing.assert_array_equal(view.view(1, 2)[rows], full[rows, 3:4])
    assert len(got._cache) <= cache_chunks
    assert (got.cache_hits, got.cache_misses) == \
        (want.cache_hits, want.cache_misses)
    assert pt_store.is_streamed(got) and not pt_store.is_streamed(full)


def test_feature_store_lru_bound_and_refusals(tmp_path):
    path = str(tmp_path / "lru.npy")
    full = _write_store(path, 1000, 4, 0)
    store = pt_store.MemmapFeatureStore(path, chunk_rows=10, cache_chunks=3)
    for r0 in range(0, 1000, 10):
        store[np.arange(r0, r0 + 10)]
        assert len(store._cache) <= 3
    assert store.cache_misses == 100
    assert store.cache_capacity_bytes == 3 * 10 * 4 * 4
    assert store.nbytes_disk == full.nbytes
    store[np.arange(990, 1000)]
    assert store.cache_misses == 100
    with pytest.raises(TypeError, match="refusing to materialize"):
        np.asarray(store)
    with pytest.raises(IndexError, match="out of range"):
        store[np.array([1000])]
    np.testing.assert_array_equal(
        np.concatenate([c for _, c in store.iter_chunks()]), full)
    store.drop_cache()
    assert len(store._cache) == 0


def test_streamed_store_refuses_eval_tables_and_bad_config(tmp_path):
    data = pt_synth.make_powerlaw_dataset("powerlaw-tiny",
                                          root=str(tmp_path))
    with pytest.raises(RuntimeError, match="streamed feature store"):
        pt_train._eval_tables(data, 8, 0)
    idx, mask = pt_train._eval_neighbor_tables(data, 8, 0)
    want = ref_train._eval_neighbor_tables(data, 8, 0)
    np.testing.assert_array_equal(idx, np.asarray(want[0]))
    np.testing.assert_array_equal(mask, np.asarray(want[1]))
    with pytest.raises(ValueError, match="streamed-store"):
        ExperimentConfig(name="bad", eval_every=-1)
    with pytest.raises(ValueError, match="target_acc"):
        ExperimentConfig(name="bad", eval_every=0, target_acc=0.5)


class _Inject(Hook):
    def __init__(self, params):
        self.params = params

    def on_train_start(self, trainer):
        trainer.state.params = checkpoint.params_from_numpy(self.params, "cpu")
        trainer.state.opt_state = trainer.optimizer.init(trainer.state.params)


def test_trainer_on_powerlaw_tiny_matches_reference(tmp_path):
    """Four SGD rounds of a streamed-store GCN run (eval_every = 0: no exact
    eval, the comm meter only) from the reference's initial parameters."""
    kw = dict(name="torch-streamed", dataset="powerlaw-tiny", n_clients=2,
              n_layers=2, hidden=16, backbone="gcn", batch_size=8, fanout=3,
              size_cap=96, table_cap=8, rounds=4, eval_every=0, lr=0.05,
              optimizer="sgd")
    rdata = ref_synth.make_powerlaw_dataset("powerlaw-tiny",
                                            root=str(tmp_path / "ref"))
    tdata = pt_synth.make_powerlaw_dataset("powerlaw-tiny",
                                           root=str(tmp_path / "pt"))
    ref = RefTrainer(RefConfig(**kw), data=rdata)
    want = ref.run()
    params0 = jax.device_get(ref_glasu.init_params(jax.random.PRNGKey(0),
                                                   ref.model_cfg))
    trainer = Trainer(ExperimentConfig(**kw), data=tdata,
                      hooks=[_Inject(params0)], device="cpu")
    assert [type(h).__name__ for h in trainer.hooks] == \
        ["CommMeterHook", "_Inject"]
    got = trainer.run()
    assert got.rounds_run == want.rounds_run == 4
    assert got.history == want.history == []
    assert got.comm_bytes == want.comm_bytes > 0
    np.testing.assert_allclose(
        trainer.state.last_losses.numpy(),
        np.asarray(jax.device_get(ref.state.last_losses)), **SIM_TOL)
    for a, b in zip(tree_leaves(got.params),
                    jax.tree_util.tree_leaves(jax.device_get(want.params))):
        assert isinstance(a, torch.Tensor)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SIM_TOL)
