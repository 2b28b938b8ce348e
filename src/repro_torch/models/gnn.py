"""MeshGraphNet [arXiv:2010.03409]: encode-process-decode over a mesh graph.

The port of the JAX package's ``models/gnn.py``, with its names and
parameter tree (``proc``'s leaves stacked on a leading n_layers axis, as
JAX's ``vmap`` builds them; a loop over that axis stands for its ``scan``).
Residual connections on both edge and node latents, LayerNorm after every
MLP except the decoder.

Message passing is a gather of node latents per edge and a scatter of edge
messages per receiving node, in plain torch (``index_select``,
``index_add_``, ``scatter_reduce``): the JAX package computes them with
``jnp`` indexing and ``jax.ops.segment_*`` outside any Pallas kernel. Their
indexing follows JAX's, with no wait on the host:

* the gather ``v[ids]`` wraps an id in [-N, 0) to id + N and clamps every
  other id into [0, N-1]; an id it clamped passes no gradient back, as
  JAX's gather, whose transpose is a scatter that drops it (``_gather_rows``,
  ``_gather``);
* the segment reductions drop a receiver outside [0, N), negatives
  included: its message goes to an extra segment N, reduced with the rest
  and then cut off, so no NaN or inf of a dropped message reaches a node,
  and it gets no gradient;
* ``max`` leaves a segment no edge reaches at -inf, and ``mean`` divides by
  ``max(count, 1)`` with the counts in the messages' type.

``forward_batched`` (JAX's ``vmap`` over small graphs) runs the graphs as
one disjoint graph: each graph's ids are wrapped, clamped and masked within
the graph before its node offset is added, so no graph reaches another's
nodes.

Where ``cfg.remat`` is set and grad is enabled, each processor layer runs
under ``torch.utils.checkpoint`` (non-reentrant), JAX's ``jax.checkpoint``
of the scan body: the same arithmetic, recomputed in the backward.

A planned step (``launch/specs.py``) runs the model on DTensors: the
sharding context's ``constrain`` places the node latents at JAX's places
(``forward``: after the node encoder, on each layer's aggregate and its new
latents), and the two ops DTensor has no rule for run on each rank's
shards through ``local_map``, with JAX's semantics: the gather reads the
whole node latents at the edges this rank holds (``_gather``), and the
segment sum reduces this rank's edges into every segment, the partial sums
then summed over the ranks that split the edges (``_aggregate``; ``max``
gathers the edges whole first, as a maximum's gradient must reach the one
rank that held it).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import init_generator, resolve_device
from repro_torch.configs.base import GNNConfig
from repro_torch.core import export
from repro_torch.core.treepath import tree_map
from repro_torch.distributed.context import constrain
from repro_torch.distributed.sharding import is_dtensor, split_dims
from repro_torch.models.layers import layer_norm, mlp_apply, mlp_params


def _mlp_dims(cfg: GNNConfig, d_in: int, d_out: int) -> Tuple[int, ...]:
    return (d_in,) + (cfg.d_hidden,) * cfg.mlp_layers + (d_out,)


def _ln_mlp_params(generator: torch.Generator, cfg: GNNConfig, d_in: int,
                   dtype) -> Dict:
    p = mlp_params(generator, _mlp_dims(cfg, d_in, cfg.d_hidden), dtype)
    p["ln_w"] = torch.ones((cfg.d_hidden,), dtype=dtype, device=generator.device)
    p["ln_b"] = torch.zeros((cfg.d_hidden,), dtype=dtype, device=generator.device)
    return p


def _ln_mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(mlp_apply(p, x), p["ln_w"], p["ln_b"])


def init_gnn(cfg: GNNConfig, generator: torch.Generator, d_feat: int,
             device="cuda") -> Dict:
    """Random parameters with the JAX init's distributions (dense layers at
    std 1/sqrt(fan_in), biases 0, norms 1 and 0), drawn from ``generator``
    on its own device and then moved to ``device``: ``node_enc`` (d_feat ->
    h), ``edge_enc`` (d_edge_in -> h), ``proc`` (per layer ``edge`` 3h -> h
    and ``node`` 2h -> h, stacked on a leading n_layers axis) and ``dec``
    (h -> d_out, no norm). Every MLP has ``mlp_layers`` hidden layers of h.
    On ``device="meta"`` the same tree of shapes and dtypes, nothing
    drawn."""
    dev = resolve_device(device)
    generator = init_generator(generator, dev)
    dt = getattr(torch, cfg.dtype)
    h = cfg.d_hidden
    params = {
        "node_enc": _ln_mlp_params(generator, cfg, d_feat, dt),
        "edge_enc": _ln_mlp_params(generator, cfg, cfg.d_edge_in, dt),
        "proc": tree_map(lambda *layers: torch.stack(layers),
                         *[{"edge": _ln_mlp_params(generator, cfg, 3 * h, dt),
                            "node": _ln_mlp_params(generator, cfg, 2 * h, dt)}
                           for _ in range(cfg.n_layers)]),
        "dec": mlp_params(generator, _mlp_dims(cfg, h, cfg.d_out), dt),
    }
    return export.to_torch(params, dev)


def params_from_numpy(tree, device="cuda"):
    """The JAX parameter tree (nested dicts and lists of numpy arrays, or
    of tensors; ``proc`` stacked on a leading n_layers axis) as the port's
    parameters: the same nesting, contiguous tensors of the same dtype on
    ``device`` (bfloat16 arrays stay bfloat16)."""
    return export.to_torch(tree, device)


def _gather_rows(ids: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows ``v[ids]`` reads in JAX for N = n rows, int64: [-n, 0)
    wraps, every other id is clamped into [0, n-1]; and whether the
    wrapped id lay inside [0, n), which is where JAX's gradient goes."""
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    return ids.clamp(0, n - 1), (ids >= 0) & (ids < n)


def _gather(v: torch.Tensor, rows: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    """``v[rows]``, passing a gradient back only where ``inside``."""
    if is_dtensor(rows):
        got = _sharded_gather(v, rows)
    else:
        got = v.index_select(0, rows)
    return torch.where(inside[:, None], got, got.detach())


def _edge_placement(t) -> tuple:
    """A DTensor's placement on its dim 0 only: ``Shard(0)`` where it is
    split by rows, ``Replicate`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    rows = split_dims(t, 0)
    return tuple(Shard(0) if i in rows else Replicate() for i in range(t.device_mesh.ndim))


def _sharded_gather(v, rows):
    """``v.index_select(0, rows)`` of DTensors: v gathered whole, each rank
    reading the rows its block of ``rows`` names; v's gradient is each
    rank's share, ``Partial`` over the mesh dims that split the rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = rows.device_mesh
    whole = tuple(Replicate() for _ in range(mesh.ndim))
    if not isinstance(v, DTensor):
        v = DTensor.from_local(v, mesh, whole, run_check=False)
    edges = _edge_placement(rows)
    v_grad = tuple(Replicate() if pl == Replicate() else Partial() for pl in edges)
    return local_map(lambda vl, rl: vl.index_select(0, rl), out_placements=list(edges),
                     in_placements=(whole, edges), in_grad_placements=(v_grad, edges),
                     device_mesh=mesh, redistribute_inputs=True)(v, rows)


def _aggregate(msgs: torch.Tensor, segments: torch.Tensor, n: int,
               kind: str) -> torch.Tensor:
    """``jax.ops.segment_{sum,max}`` of msgs (E, h) into n segments, with
    ``mean`` as their sum over ``max(count, 1)``. ``segments`` are in
    [0, n], a dropped edge's n: the reduction runs over n + 1 segments and
    returns the first n. DTensors reduce on each rank's edges
    (``_sharded_aggregate``)."""
    if is_dtensor(msgs):
        return _sharded_aggregate(msgs, segments, n, kind)
    shape = (n + 1, msgs.shape[1])
    if kind in ("sum", "mean"):
        s = torch.zeros(shape, dtype=msgs.dtype, device=msgs.device).index_add_(
            0, segments, msgs)[:n]
        if kind == "sum":
            return s
        c = torch.zeros((n + 1, 1), dtype=msgs.dtype, device=msgs.device).index_add_(
            0, segments, torch.ones((segments.shape[0], 1), dtype=msgs.dtype,
                                    device=msgs.device))[:n]
        return s / torch.clamp(c, min=1.0)
    if kind == "max":
        init = torch.full(shape, float("-inf"), dtype=msgs.dtype, device=msgs.device)
        return init.scatter_reduce(0, segments[:, None].expand_as(msgs), msgs, "amax")[:n]
    raise ValueError(kind)


def _sharded_aggregate(msgs, segments, n: int, kind: str):
    """``_aggregate`` of DTensor messages and segments: each rank reduces
    its block of edges into all n segments, and the partial sums (and
    counts) are ``Partial`` over the mesh dims that split the edges; ``max``
    gathers the edges whole first and reduces them on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = msgs.device_mesh
    if not isinstance(segments, DTensor):
        segments = DTensor.from_local(segments, mesh, _edge_placement(msgs), run_check=False)
    edges = _edge_placement(msgs)
    if kind == "max":
        edges = tuple(Replicate() for _ in edges)
    out = tuple(Partial() if pl != Replicate() else Replicate() for pl in edges)
    if kind == "mean":
        s = local_map(lambda m, g: _aggregate(m, g, n, "sum"), out_placements=list(out),
                      in_placements=(edges, edges), device_mesh=mesh,
                      redistribute_inputs=True)(msgs, segments)
        c = local_map(lambda g: torch.zeros((n + 1, 1), dtype=msgs.dtype, device=g.device)
                      .index_add_(0, g, torch.ones((g.shape[0], 1), dtype=msgs.dtype,
                                                   device=g.device))[:n],
                      out_placements=list(out), in_placements=(edges,), device_mesh=mesh,
                      redistribute_inputs=True)(segments)
        return s / torch.clamp(c, min=1.0)
    return local_map(lambda m, g: _aggregate(m, g, n, kind), out_placements=list(out),
                     in_placements=(edges, edges), device_mesh=mesh,
                     redistribute_inputs=True)(msgs, segments)


def _process(params: Dict, node_feats: torch.Tensor, edge_feats: torch.Tensor,
             senders, receivers, segments: torch.Tensor,
             cfg: GNNConfig, place=lambda x, kind: x) -> torch.Tensor:
    """Encode, process and decode one (possibly disjoint) graph whose ids
    are resolved: ``senders``/``receivers`` the gathered rows and whether
    each passes a gradient (``_gather_rows``), ``segments`` each edge's
    segment (N, the graph's node count, where it is dropped)."""
    n = node_feats.shape[0]
    dt = getattr(torch, cfg.dtype)
    v = place(_ln_mlp(params["node_enc"], node_feats.to(dt)), "nodes")
    e = _ln_mlp(params["edge_enc"], edge_feats.to(dt))

    def body(v, e, lp):
        msg_in = torch.cat([e, _gather(v, *senders), _gather(v, *receivers)], dim=-1)
        e_new = e + _ln_mlp(lp["edge"], msg_in)
        agg = place(_aggregate(e_new, segments, n, cfg.aggregator), "nodes")
        v_new = v + _ln_mlp(lp["node"], torch.cat([v, agg], dim=-1))
        return place(v_new, "nodes"), e_new

    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(params["proc"]["edge"]["ln_w"].shape[0]):
        lp = tree_map(lambda t: t[i], params["proc"])
        if remat:
            v, e = checkpoint(body, v, e, lp, use_reentrant=False)
        else:
            v, e = body(v, e, lp)
    return mlp_apply(params["dec"], v)


def forward(params: Dict, node_feats: torch.Tensor, edge_feats: torch.Tensor,
            senders: torch.Tensor, receivers: torch.Tensor, cfg: GNNConfig,
            ) -> torch.Tensor:
    """node_feats (N, d_feat), edge_feats (E, d_edge) -> (N, d_out) in
    cfg.dtype."""
    n = node_feats.shape[0]
    receivers = receivers.long()
    keep = (receivers >= 0) & (receivers < n)
    return _process(params, node_feats, edge_feats, _gather_rows(senders, n),
                    _gather_rows(receivers, n), torch.where(keep, receivers, n), cfg,
                    constrain)


def forward_batched(params: Dict, node_feats: torch.Tensor,
                    edge_feats: torch.Tensor, senders: torch.Tensor,
                    receivers: torch.Tensor, cfg: GNNConfig) -> torch.Tensor:
    """Batched small graphs (molecule shape): a leading batch dim G on all
    args -> (G, N, d_out). The graphs run as one disjoint graph of G * N
    nodes, each graph's ids resolved within it before its offset is added."""
    g, n = node_feats.shape[:2]
    off = (torch.arange(g, device=senders.device) * n)[:, None]

    def flat(ids):
        rows, inside = _gather_rows(ids, n)
        return (rows + off).reshape(-1), inside.reshape(-1)

    receivers = receivers.long()
    keep = (receivers >= 0) & (receivers < n)
    out = _process(params, node_feats.reshape(g * n, -1),
                   edge_feats.reshape(-1, edge_feats.shape[-1]), flat(senders),
                   flat(receivers), torch.where(keep, receivers + off, g * n).reshape(-1),
                   cfg)
    return out.reshape(g, n, -1)


def loss_fn(params: Dict, batch: Dict, cfg: GNNConfig,
            batched: bool = False) -> Tuple[torch.Tensor, Dict]:
    """MSE node-regression loss (mesh dynamics target), float32: the sum
    over d_out of the squared error, averaged over the nodes, or over the
    nodes ``node_mask`` keeps (divided by ``max(sum(mask), 1)``)."""
    f = forward_batched if batched else forward
    pred = f(params, batch["nodes"], batch["edges"], batch["senders"],
             batch["receivers"], cfg)
    mask: Optional[torch.Tensor] = batch.get("node_mask")
    err = torch.square(pred.float() - batch["targets"].float()).sum(-1)
    if mask is not None:
        loss = torch.sum(err * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        loss = torch.mean(err)
    return loss, {"mse": loss}
