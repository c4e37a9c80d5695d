"""The reference's own inputs: the graph it draws again from the
configuration's seed is the program's, array for array."""
import numpy as np
import pytest

from perfbench import harness
from perfbench.reference import sbm
from perfbench.tests import cells
from perfbench.tests.cells import ROOT

CORA = harness.load_json(ROOT / "perfbench" / "configs"
                         / "cora-gcnii-glasu.json")


@pytest.mark.parametrize("graph, m", [(cells.TINY_SBM, 2),
                                      (CORA["graph"], 3)],
                         ids=["tiny", "cora"])
def test_frozen_generator_draws_the_programs_graph(graph, m):
    from repro_torch.graph import synth
    spec = {k: v for k, v in graph.items()
            if k not in ("generator", "name", "seed")}
    data = synth.make_vfl_dataset(graph["name"], n_clients=m,
                                  seed=graph["seed"],
                                  spec=synth.DatasetSpec(**spec))
    raw = sbm.raw_graph(graph, m)
    assert raw.n == data.n_nodes
    assert np.array_equal(raw.labels, data.full.labels)
    assert np.array_equal(raw.train_idx, data.full.train_idx)
    for (indptr, indices), feats, c in zip(raw.graphs, raw.features,
                                           data.clients):
        assert np.array_equal(indptr, c.indptr)
        assert np.array_equal(indices, c.indices)
        assert np.array_equal(feats, c.features)
