"""Port parity: host graph data and evaluation tables, bitwise.

``repro_torch``'s numpy modules (datasets, CSR, padded neighbor tables,
eval tables) must reproduce ``repro``'s exactly, including how the
generators' draws are consumed — every later parity test stands on them.
"""
import numpy as np
import pytest

from repro.core import train as ref_train
from repro.graph import graph as ref_graph
from repro.graph import synth as ref_synth
from repro_torch.core import train as pt_train
from repro_torch.graph import graph as pt_graph
from repro_torch.graph import synth as pt_synth


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
    ("natural", 3, 1, NATURAL)])
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


@pytest.mark.parametrize("name", pt_synth.NOT_PORTED)
def test_powerlaw_profiles_raise(name):
    assert name in ref_synth.POWERLAW_SPECS
    with pytest.raises(NotImplementedError, match="not ported yet"):
        pt_synth.make_vfl_dataset(name)


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
