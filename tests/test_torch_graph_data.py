"""The port's graph data (``repro_torch.data.graph``) against the JAX
package's ``repro.data.graph``.

For equal seeds every array is byte-equal in both packages: the random and
the mesh graphs' CSR arrays, their edge lists, ``graph_batch``'s features,
ids and targets (single graphs and batches of graphs), and the neighbor
sampler's whole output, truncation included. ``tests/test_data.py``'s two
graph tests are mirrored on the port.
"""
import numpy as np
import pytest

from repro.data import graph as JG
from repro_torch.data import graph as G


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


def _csr(g):
    return {"indptr": g.indptr, "indices": g.indices, "n_nodes": np.asarray(g.n_nodes)}


@pytest.mark.parametrize("n,deg,seed", [(1, 3, 0), (50, 4, 1), (2000, 10, 3)])
def test_random_graph_is_byte_equal(n, deg, seed):
    got, want = G.random_graph(n, deg, seed=seed), JG.random_graph(n, deg, seed=seed)
    _same(_csr(got), _csr(want))
    assert got.n_edges == want.n_edges
    _same(dict(zip("sr", G.to_edge_list(got))), dict(zip("sr", JG.to_edge_list(want))))


@pytest.mark.parametrize("side", [1, 2, 5, 17])
def test_mesh_graph_is_byte_equal(side):
    got, want = G.mesh_graph(side), JG.mesh_graph(side)
    _same(_csr(got), _csr(want))
    _same(dict(zip("sr", G.to_edge_list(got))), dict(zip("sr", JG.to_edge_list(want))))


@pytest.mark.parametrize("kw", [dict(n_nodes=30, n_edges=64, d_feat=16),
                                dict(n_nodes=200, n_edges=800, d_feat=16, d_out=2, seed=7),
                                dict(n_nodes=30, n_edges=64, d_feat=16, n_graphs=5, seed=2),
                                dict(n_nodes=9, n_edges=3, d_feat=1, d_edge=2, d_out=3)])
def test_graph_batch_is_byte_equal(kw):
    _same(G.graph_batch(**kw), JG.graph_batch(**kw))


@pytest.mark.parametrize("graph,fanout,n_seeds,pads,seed", [
    ("random", (15, 10), 32, (8192, 16384), 0),
    ("random", (5, 3, 2), 7, (4096, 4096), 4),
    ("mesh", (4, 4), 3, (64, 128), 1),
    ("random", (15, 10), 32, (300, 200), 2),        # truncated to the pads
])
def test_neighbor_sampler_is_byte_equal(graph, fanout, n_seeds, pads, seed):
    """Two samples in a row from each package's sampler (the sampler's
    generator advances alike), the same seeds, the same pads."""
    make = {"random": lambda m: m.random_graph(2000, 10, seed=3),
            "mesh": lambda m: m.mesh_graph(9)}[graph]
    ours = G.NeighborSampler(make(G), fanout, seed=seed)
    theirs = JG.NeighborSampler(make(JG), fanout, seed=seed)
    seeds = np.arange(n_seeds) * 5
    for _ in range(2):
        _same(ours.sample(seeds, *pads), theirs.sample(seeds, *pads))


def test_neighbor_sampler_validity():
    """``tests/test_data.py::test_neighbor_sampler_validity`` on the port."""
    g = G.random_graph(2000, 10, seed=3)
    ns = G.NeighborSampler(g, (15, 10), seed=0)
    sub = ns.sample(np.arange(32), pad_nodes=8192, pad_edges=16384)
    n = int(sub["node_mask"].sum())
    e = int(sub["edge_mask"].sum())
    assert 32 <= n <= 32 * (1 + 15 + 150)
    assert e <= 32 * (15 + 150)
    assert sub["senders"][:e].max() < n
    assert sub["receivers"][:e].max() < n
    assert np.all(sub["senders"][e:] == 0)


def test_mesh_graph_degrees():
    """``tests/test_data.py::test_mesh_graph_degrees`` on the port."""
    g = G.mesh_graph(5)
    degs = np.diff(g.indptr)
    assert degs.min() == 2 and degs.max() == 4
    s, r = G.to_edge_list(g)
    assert len(s) == g.n_edges
