"""The graph of a configuration, drawn from its own seed (not the run's).

The program receives its dataset from its own generator
(``graph.synth.make_vfl_dataset``: the stochastic-block-model proxy of a
Planetoid graph); the reference draws the same graph again from its
frozen copy, ``reference/sbm.py``, and never reads the program's arrays.
"""
from __future__ import annotations

from .reference import sbm


def build(graph: dict, n_clients: int):
    """(the program's ``VFLDataset``, the reference's ``RawGraph``)."""
    from repro_torch.graph import synth
    if graph["generator"] != "sbm":
        raise ValueError(f"unknown graph generator {graph['generator']!r}")
    spec = {k: v for k, v in graph.items()
            if k not in ("generator", "name", "seed")}
    data = synth.make_vfl_dataset(graph["name"], n_clients=n_clients,
                                  seed=graph["seed"],
                                  spec=synth.DatasetSpec(**spec))
    return data, sbm.raw_graph(graph, n_clients)
