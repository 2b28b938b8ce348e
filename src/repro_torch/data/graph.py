"""Graph data: generators + a REAL CSR neighbor sampler (minibatch_lg shape).

The sampler is host-side numpy over a CSR adjacency — fanout-bounded k-hop
expansion with node renumbering into a padded subgraph, which is what a
production GNN trainer feeds the device (fixed shapes, mask for stragglers).

A numpy copy of the JAX package's ``data/graph.py``: the same seed gives the
same arrays, byte for byte, in both packages, the sampler's included.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray        # (N+1,)
    indices: np.ndarray       # (nnz,) neighbor ids
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return len(self.indices)


def random_graph(n_nodes: int, avg_degree: int, seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    counts = rng.poisson(avg_degree, n_nodes).clip(1)
    indptr = np.zeros(n_nodes + 1, np.int64)
    indptr[1:] = np.cumsum(counts)
    indices = rng.integers(0, n_nodes, int(indptr[-1])).astype(np.int32)
    return CSRGraph(indptr, indices, n_nodes)


def mesh_graph(side: int) -> CSRGraph:
    """4-connected 2D mesh (MeshGraphNet-style simulation mesh)."""
    n = side * side
    nbrs = [[] for _ in range(n)]
    for r in range(side):
        for c in range(side):
            i = r * side + c
            for dr, dc in ((0, 1), (1, 0), (0, -1), (-1, 0)):
                rr, cc = r + dr, c + dc
                if 0 <= rr < side and 0 <= cc < side:
                    nbrs[i].append(rr * side + cc)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum([len(x) for x in nbrs])
    indices = np.concatenate([np.asarray(x, np.int32) for x in nbrs])
    return CSRGraph(indptr, indices, n)


def to_edge_list(g: CSRGraph) -> Tuple[np.ndarray, np.ndarray]:
    senders = np.repeat(np.arange(g.n_nodes, dtype=np.int32),
                        np.diff(g.indptr))
    return senders, g.indices.astype(np.int32)


class NeighborSampler:
    """Fanout-bounded k-hop subgraph sampling with renumbering + padding."""

    def __init__(self, graph: CSRGraph, fanout: Tuple[int, ...], seed: int = 0):
        self.g = graph
        self.fanout = fanout
        self.rng = np.random.default_rng(seed)

    def _sample_neighbors(self, nodes: np.ndarray, k: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Per node: up to k uniform neighbors. Returns (senders, receivers)."""
        snd, rcv = [], []
        for v in nodes:
            s, e = self.g.indptr[v], self.g.indptr[v + 1]
            deg = e - s
            if deg == 0:
                continue
            take = min(k, deg)
            picks = self.g.indices[s + self.rng.choice(deg, take, replace=False)]
            snd.append(picks)
            rcv.append(np.full(take, v, np.int32))
        if not snd:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        return np.concatenate(snd), np.concatenate(rcv)

    def sample(self, seeds: np.ndarray, pad_nodes: int, pad_edges: int
               ) -> Dict[str, np.ndarray]:
        """k-hop expansion from seeds; renumber into [0, pad_nodes)."""
        frontier = seeds.astype(np.int64)
        all_s, all_r = [], []
        seen = set(frontier.tolist())
        for k in self.fanout:
            s, r = self._sample_neighbors(frontier, k)
            all_s.append(s)
            all_r.append(r)
            nxt = [v for v in np.unique(s) if v not in seen]
            seen.update(nxt)
            frontier = np.asarray(nxt, np.int64)
            if len(frontier) == 0:
                break
        senders = np.concatenate(all_s) if all_s else np.zeros(0, np.int32)
        receivers = np.concatenate(all_r) if all_r else np.zeros(0, np.int32)
        node_ids = np.unique(np.concatenate(
            [seeds.astype(np.int64), senders, receivers]))
        remap = {int(v): i for i, v in enumerate(node_ids)}
        senders = np.asarray([remap[int(v)] for v in senders], np.int32)
        receivers = np.asarray([remap[int(v)] for v in receivers], np.int32)
        n, e = len(node_ids), len(senders)
        if n > pad_nodes or e > pad_edges:
            # truncate (production samplers bound work per batch)
            keep = (senders < pad_nodes) & (receivers < pad_nodes)
            senders, receivers = senders[keep][:pad_edges], receivers[keep][:pad_edges]
            node_ids = node_ids[:pad_nodes]
            n, e = len(node_ids), len(senders)
        out = {
            "node_ids": np.pad(node_ids, (0, pad_nodes - n)),
            "node_mask": np.pad(np.ones(n, np.float32), (0, pad_nodes - n)),
            # pad edges as self-loops on padded node 0 with zero features
            "senders": np.pad(senders, (0, pad_edges - e)),
            "receivers": np.pad(receivers, (0, pad_edges - e)),
            "edge_mask": np.pad(np.ones(e, np.float32), (0, pad_edges - e)),
            "n_seed": np.asarray(len(seeds), np.int32),
        }
        return out


def graph_batch(n_nodes: int, n_edges: int, d_feat: int, d_edge: int = 4,
                d_out: int = 2, seed: int = 0, n_graphs: int = 0
                ) -> Dict[str, np.ndarray]:
    """Synthetic node/edge features + regression targets for a GNN step."""
    rng = np.random.default_rng(seed)
    shape = (n_graphs,) if n_graphs else ()
    return {
        "nodes": rng.normal(size=shape + (n_nodes, d_feat)).astype(np.float32),
        "edges": rng.normal(size=shape + (n_edges, d_edge)).astype(np.float32),
        "senders": rng.integers(0, n_nodes, shape + (n_edges,)).astype(np.int32),
        "receivers": rng.integers(0, n_nodes, shape + (n_edges,)).astype(np.int32),
        "targets": rng.normal(size=shape + (n_nodes, d_out)).astype(np.float32),
    }
