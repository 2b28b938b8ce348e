"""Dry-run cell planning: (arch x shape x mesh) -> a plan a step runs from.

The port of the JAX package's ``launch/specs.py``, function for function.
``plan_cell`` builds, WITHOUT allocating anything (every init on
``device="meta"``, the twin of ``jax.eval_shape``):
  - the step function (train step / prefill / decode / serve_step /
    retrieval),
  - the arguments as meta tensors at their global shapes (params, optimizer
    state, batch, KV cache), with ``in_shardings`` beside them, a tree of
    ``sharding.NamedSharding`` of the same structure (JAX carries the
    sharding on each ``ShapeDtypeStruct``),
  - ``out_shardings`` enforcing the ZeRO/TP contract on outputs,
  - metadata the roofline needs (trip count, token/edge counts).

The mesh is an ``AbstractMesh`` (axis names and sizes: the plan's
shapes and specs, and nothing to run) or a ``DeviceMesh``, on which
``dtensor_args`` places the arguments as DTensors (meta ones for the dry
run, real ones from ``place``) and ``fn`` runs. ``fn`` places its outputs
by ``out_shardings`` itself (``jax.jit(out_shardings=...)``'s part): the
ZeRO-sharded update all-gathers its params back onto their layout. It runs
its model under ``implicit_replication``, so the plain tensors a model
makes (positions, masks, offsets) act as replicated DTensors.

Divisibility discipline, as in JAX: batch-like leading dims are divisible
by the data axes (256/512-wide meshes); ragged totals (graph edge counts,
candidate counts) are padded up to a multiple of the full mesh.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs import get_config, get_shapes, shape_applicable
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.treepath import tree_map
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.context import (activation_sharding, gnn_rules,
                                             lm_rules, recsys_rules)
from repro_torch.distributed.mesh import axis_size, data_axes, mesh_shape
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import sm_cnn as cnn_lib
from repro_torch.models import transformer as tfm
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_loop import value_and_grad

META = torch.device("meta")


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


@dataclasses.dataclass
class CellPlan:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: Tuple[Any, ...]                  # trees of meta tensors, global shapes
    in_shardings: Tuple[Any, ...]          # trees of NamedSharding, as args
    out_shardings: Any
    donate: Tuple[int, ...]
    default_trip: int
    meta: Dict[str, Any]


def _sds(shape, dtype, mesh, spec) -> Tuple[torch.Tensor, NamedSharding]:
    """A meta tensor and its sharding (split into the two trees by
    ``_split``)."""
    return torch.empty(shape, dtype=dtype, device=META), NamedSharding(mesh, spec)


def _split(tree) -> Tuple[Any, Any]:
    """A tree of ``_sds`` pairs -> (tree of tensors, tree of shardings)."""
    if isinstance(tree, dict):
        pairs = {k: _split(v) for k, v in tree.items()}
        return ({k: a for k, (a, _) in pairs.items()}, {k: b for k, (_, b) in pairs.items()})
    return tree


def train_optimizer() -> opt_lib.Optimizer:
    """The optimizer every planned train step updates with."""
    return opt_lib.adamw(opt_lib.warmup_cosine_schedule(3e-4, 2000, 100000),
                         weight_decay=0.1)


def _abstract_train_state(init_fn, family: str, mesh):
    """(param structs, shardings, opt structs, shardings, optimizer,
    grad_shardings). grad_shardings follow the ZeRO-extended layout so the
    train step can place grads by a reduce-scatter instead of an
    all-reduce."""
    opt = train_optimizer()
    pshape = init_fn()
    pspecs = SH.param_specs(pshape, family, mesh)
    pshard = SH.named(mesh, pspecs)
    oshape = opt.init(pshape)
    ospecs = SH.opt_state_specs(oshape, pshape, family, mesh)
    oshard = SH.named(mesh, ospecs)
    gspecs = tree_map(lambda leaf, spec: SH.zero_shard_spec(spec, tuple(leaf.shape), mesh),
                      pshape, pspecs)
    gshard = SH.named(mesh, gspecs)
    return pshape, pshard, oshape, oshard, opt, gshard


def _dp_spec(mesh) -> P:
    dp = data_axes(mesh)
    return P(dp if len(dp) > 1 else dp[0])


def _every(mesh) -> Tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def _gen() -> torch.Generator:
    return torch.Generator()     # never drawn from: every init here is on meta


# ---------------------------------------------------------------------------
# placing: outputs by out_shardings, arguments as DTensors
# ---------------------------------------------------------------------------

def place(tree, shardings):
    """Each DTensor leaf of ``tree`` redistributed onto its sharding's
    placements (``shardings`` a tree of ``NamedSharding`` of the same
    structure, or one for the whole tree); plain leaves as they are."""
    from torch.distributed.tensor import DTensor

    if isinstance(shardings, NamedSharding):
        return tree_map(lambda t: _place_one(t, shardings), tree)
    if isinstance(tree, DTensor) or not isinstance(tree, (dict, list, tuple)):
        return _place_one(tree, shardings)
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    out = [place(v, s) for v, s in zip(tree, shardings)]
    return tuple(out) if isinstance(tree, tuple) else out


def _place_one(t, sharding: NamedSharding):
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, sharding.placements)


def _placed(step: Callable, out_shardings) -> Callable:
    @functools.wraps(step)
    def fn(*args):
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            return place(step(*args), out_shardings)
    return fn


def dtensor_args(plan: CellPlan, mesh, values=None):
    """The plan's arguments as DTensors on ``mesh`` (a ``DeviceMesh`` of the
    plan's axes), each placed by its sharding: with ``values`` (trees of
    the arguments' full tensors, e.g. on the card) each rank keeps its
    block of them (on a mesh of one rank, the tensor itself, not a copy);
    without, meta DTensors of the plan's shapes, whose local shards are
    meta tensors of this rank's block shape."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, sh):
        if mesh.size() == 1:     # the tensor is this rank's block: wrap it, no copy
            return DTensor.from_local(t, mesh, sh.placements, run_check=False)
        return distribute_tensor(t, mesh, sh.placements, src_data_rank=None)

    src = plan.args if values is None else values
    return tuple(tree_map(one, a, s) for a, s in zip(src, plan.in_shardings))


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _plan_lm(arch: str, cfg, shape: ShapeSpec, mesh,
             sequence_parallel: bool = True) -> CellPlan:
    dp = _dp_spec(mesh)
    rules = lm_rules(mesh, sequence_parallel=sequence_parallel)

    moe_a2a = cfg.moe is not None
    # dense train: FSDP params (no per-layer activation collectives), each
    # layer's weights gathered before it runs; MoE train: TP/EP keeps
    # experts resident on the model axis.
    fsdp = shape.kind == "train" and cfg.moe is None

    def ctx(fn):
        @functools.wraps(fn)
        def wrapped(*a):
            with activation_sharding(mesh, rules, moe_a2a=moe_a2a, fsdp=fsdp):
                return fn(*a)
        return wrapped

    if shape.kind == "train":
        fam = "lm_fsdp" if fsdp else "lm"
        ps, pshard, os_, oshard, opt, gshard = _abstract_train_state(
            lambda: tfm.init_lm(cfg, _gen(), device=META), fam, mesh)
        batch, bshard = _split({
            "tokens": _sds((shape.global_batch, shape.seq_len), torch.int32,
                           mesh, P(*dp, None)),
            "labels": _sds((shape.global_batch, shape.seq_len), torch.int32,
                           mesh, P(*dp, None)),
        })

        @ctx
        def train_step(params, opt_state, b):
            loss, _, grads = value_and_grad(
                lambda p, bb: tfm.loss_fn(p, bb, cfg), params, b)
            # ZeRO contract: grads land reduce-scattered in the optimizer
            # shard layout, not all-reduced
            grads = place(grads, gshard)
            params, opt_state = opt.update(params, grads, opt_state)
            return params, opt_state, loss

        out = (pshard, oshard, NamedSharding(mesh, P()))
        return CellPlan(arch, shape.name, shape.kind, _placed(train_step, out),
                        (ps, os_, batch), (pshard, oshard, bshard), out,
                        donate=(0, 1), default_trip=cfg.n_layers,
                        meta={"tokens": shape.global_batch * shape.seq_len})

    serve_cfg = dataclasses.replace(cfg, remat=False)
    ps = tfm.init_lm(serve_cfg, _gen(), device=META)
    pshard = SH.param_shardings(ps, "lm", mesh)
    vocab_ax = "model" if cfg.vocab_size % axis_size(mesh, "model") == 0 else None

    if shape.kind == "prefill":
        tokens, tshard = _sds((shape.global_batch, shape.seq_len), torch.int32,
                              mesh, P(*dp, None))
        cshape = tfm.init_cache(serve_cfg, shape.global_batch, shape.seq_len, device=META)
        cshard = SH.named(mesh, SH.cache_specs(cshape, serve_cfg, mesh))
        logit_spec = P(*dp, vocab_ax)

        @ctx
        def prefill_step(params, toks):
            return tfm.prefill(params, toks, serve_cfg)

        out = (NamedSharding(mesh, logit_spec), cshard)
        return CellPlan(arch, shape.name, shape.kind, _placed(prefill_step, out),
                        (ps, tokens), (pshard, tshard), out,
                        donate=(), default_trip=cfg.n_layers,
                        meta={"tokens": shape.global_batch * shape.seq_len})

    if shape.kind in ("decode", "long_decode"):
        b = shape.global_batch
        # >5B-param models quantize the decode cache to int8 (KIVI-style)
        if cfg.n_params() > 5e9:
            serve_cfg = dataclasses.replace(serve_cfg, kv_quant=True)
        cs = tfm.init_cache(serve_cfg, b, shape.seq_len, device=META)
        cshard = SH.named(mesh, SH.cache_specs(cs, serve_cfg, mesh))
        toks, tshard = _sds((b,), torch.int32, mesh, dp)
        pos, pos_shard = _sds((b,), torch.int32, mesh, dp)
        logit_spec = P(*_dp_spec(mesh), vocab_ax)

        def decode(params, cache, t, p):
            return tfm.decode_step(params, cache, t, p, serve_cfg)

        out = (NamedSharding(mesh, logit_spec), cshard)
        return CellPlan(arch, shape.name, shape.kind, _placed(decode, out),
                        (ps, cs, toks, pos), (pshard, cshard, tshard, pos_shard), out,
                        donate=(1,), default_trip=cfg.n_layers,
                        meta={"tokens": b, "kv_len": shape.seq_len})

    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _plan_gnn(arch: str, cfg, shape: ShapeSpec, mesh) -> CellPlan:
    n_dev = axis_size(mesh, *_every(mesh))
    every = _every(mesh)
    dp = _dp_spec(mesh)

    batched = shape.kind == "graph_batched"
    d_feat = shape.d_feat
    init = lambda: gnn_lib.init_gnn(cfg, _gen(), d_feat, device=META)  # noqa: E731
    ps, pshard, os_, oshard, opt, _g = _abstract_train_state(init, "gnn", mesh)
    dt = getattr(torch, cfg.dtype)

    if batched:
        g, n, e = shape.n_graphs, shape.n_nodes, shape.n_edges
        batch = {
            "nodes": _sds((g, n, d_feat), dt, mesh, P(*dp, None, None)),
            "edges": _sds((g, e, cfg.d_edge_in), dt, mesh, P(*dp, None, None)),
            "senders": _sds((g, e), torch.int32, mesh, P(*dp, None)),
            "receivers": _sds((g, e), torch.int32, mesh, P(*dp, None)),
            "targets": _sds((g, n, cfg.d_out), dt, mesh, P(*dp, None, None)),
        }
        tokens = g * n
    else:
        # nodes pad to 512 so node latents can shard over 'model'; padded
        # nodes receive no edges and zero targets
        n = _pad_to(shape.n_nodes, 512)
        e = _pad_to(shape.n_edges, n_dev)
        batch = {
            "nodes": _sds((n, d_feat), dt, mesh, P(None, None)),
            "edges": _sds((e, cfg.d_edge_in), dt, mesh, P(every, None)),
            "senders": _sds((e,), torch.int32, mesh, P(every)),
            "receivers": _sds((e,), torch.int32, mesh, P(every)),
            "targets": _sds((n, cfg.d_out), dt, mesh, P(None, None)),
        }
        if shape.kind == "graph_sampled":
            batch["node_mask"] = _sds((n,), dt, mesh, P(None))
        tokens = n
    batch, bshard = _split(batch)

    def train_step(params, opt_state, b):
        with activation_sharding(mesh, gnn_rules(mesh)):
            loss, _, grads = value_and_grad(
                lambda p, bb: gnn_lib.loss_fn(p, bb, cfg, batched=batched), params, b)
        params, opt_state = opt.update(params, grads, opt_state)
        return params, opt_state, loss

    out = (pshard, oshard, NamedSharding(mesh, P()))
    return CellPlan(arch, shape.name, shape.kind, _placed(train_step, out),
                    (ps, os_, batch), (pshard, oshard, bshard), out,
                    donate=(0, 1), default_trip=cfg.n_layers,
                    meta={"nodes": tokens, "edges": shape.n_edges})


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def _rec_batch_structs(cfg, batch_size: int, mesh, kind: str):
    """The batch of a train or serve cell as ``_sds`` pairs: the recsys
    MLPs replicate and the tables row-shard over the full mesh, so the
    batch shards over EVERY axis (pure DP) when divisible."""
    every = _every(mesh)
    n_every = axis_size(mesh, *every)
    dp = P(every) if batch_size % n_every == 0 else _dp_spec(mesh)
    b = batch_size
    row = P(*dp, None)
    if cfg.kind == "fm":
        return {"ids": _sds((b, cfg.n_sparse), torch.int32, mesh, row),
                "label": _sds((b,), torch.float32, mesh, dp)}
    if cfg.kind == "dlrm":
        return {"dense": _sds((b, cfg.n_dense), torch.float32, mesh, row),
                "ids": _sds((b, cfg.n_sparse), torch.int32, mesh, row),
                "label": _sds((b,), torch.float32, mesh, dp)}
    if cfg.kind == "din":
        return {"hist": _sds((b, cfg.seq_len), torch.int32, mesh, row),
                "hist_mask": _sds((b, cfg.seq_len), torch.float32, mesh, row),
                "target": _sds((b,), torch.int32, mesh, dp),
                "label": _sds((b,), torch.float32, mesh, dp)}
    # bert4rec
    out = {"seq": _sds((b, cfg.seq_len), torch.int32, mesh, row)}
    if kind == "rec_train":
        out["label"] = _sds((b,), torch.int32, mesh, dp)
        out["negatives"] = _sds((b, cfg.n_negatives), torch.int32, mesh, row)
    else:
        out["target"] = _sds((b,), torch.int32, mesh, dp)
    return out


def _plan_recsys(arch: str, cfg, shape: ShapeSpec, mesh) -> CellPlan:
    every = _every(mesh)
    trip = cfg.n_blocks if cfg.kind == "bert4rec" else 1
    init = lambda: rec_lib.init_model(cfg, _gen(), device=META)  # noqa: E731

    if shape.kind == "rec_train":
        ps, pshard, os_, oshard, opt, _g = _abstract_train_state(init, "recsys", mesh)
        batch, bshard = _split(_rec_batch_structs(cfg, shape.batch, mesh, shape.kind))

        def train_step(params, opt_state, b):
            loss, _, grads = value_and_grad(
                lambda p, bb: rec_lib.loss_fn(p, bb, cfg), params, b)
            params, opt_state = opt.update(params, grads, opt_state)
            return params, opt_state, loss

        out = (pshard, oshard, NamedSharding(mesh, P()))
        return CellPlan(arch, shape.name, shape.kind, _placed(train_step, out),
                        (ps, os_, batch), (pshard, oshard, bshard), out,
                        donate=(0, 1), default_trip=trip,
                        meta={"examples": shape.batch})

    ps = init()
    pshard = SH.param_shardings(ps, "recsys", mesh)

    if shape.kind == "rec_serve":
        structs = _rec_batch_structs(cfg, shape.batch, mesh, shape.kind)
        structs.pop("label", None)
        batch, bshard = _split(structs)
        out_dp = (P(every) if shape.batch % axis_size(mesh, *every) == 0
                  else _dp_spec(mesh))
        out = NamedSharding(mesh, out_dp)
        fn = functools.partial(rec_lib.serve_step, cfg=cfg)
        return CellPlan(arch, shape.name, shape.kind, _placed(fn, out), (ps, batch),
                        (pshard, bshard), out, donate=(), default_trip=trip,
                        meta={"examples": shape.batch})

    # rec_retrieval: 1 query vs n_candidates, candidates sharded over EVERYTHING
    n_cand = _pad_to(shape.n_candidates, axis_size(mesh, *every))
    cands = _sds((n_cand,), torch.int32, mesh, P(every))
    if cfg.kind == "fm":
        batch = {"user_ids": _sds((1, cfg.n_sparse - 1), torch.int32, mesh, P(None, None)),
                 "candidates": cands}
        out_spec = P(None, every)
    elif cfg.kind == "dlrm":
        batch = {"dense": _sds((1, cfg.n_dense), torch.float32, mesh, P(None, None)),
                 "user_ids": _sds((1, cfg.n_sparse - 1), torch.int32, mesh, P(None, None)),
                 "candidates": cands}
        out_spec = P(every)
    elif cfg.kind == "din":
        batch = {"hist": _sds((1, cfg.seq_len), torch.int32, mesh, P(None, None)),
                 "hist_mask": _sds((1, cfg.seq_len), torch.float32, mesh, P(None, None)),
                 "candidates": cands}
        out_spec = P(every)
    else:  # bert4rec
        batch = {"seq": _sds((1, cfg.seq_len), torch.int32, mesh, P(None, None)),
                 "candidates": cands}
        out_spec = P(None, every)
    batch, bshard = _split(batch)
    rrules = recsys_rules(mesh)

    def fn(params, b):
        with activation_sharding(mesh, rrules):
            return rec_lib.retrieval_step(params, b, cfg)

    out = NamedSharding(mesh, out_spec)
    return CellPlan(arch, shape.name, shape.kind, _placed(fn, out), (ps, batch),
                    (pshard, bshard), out, donate=(),
                    default_trip=trip, meta={"candidates": shape.n_candidates})


# ---------------------------------------------------------------------------
# Text-pair (the paper's own model)
# ---------------------------------------------------------------------------

def _plan_textpair(arch: str, cfg, shape: ShapeSpec, mesh) -> CellPlan:
    dp = _dp_spec(mesh)
    b = shape.batch
    init = lambda: cnn_lib.init_sm_cnn(cfg, _gen(), device=META)  # noqa: E731
    structs = {
        "q_tok": _sds((b, cfg.max_len), torch.int32, mesh, P(*dp, None)),
        "a_tok": _sds((b, cfg.max_len), torch.int32, mesh, P(*dp, None)),
        "feats": _sds((b, cfg.n_extra_feats), torch.float32, mesh, P(*dp, None)),
    }
    if shape.kind == "pair_train":
        structs["label"] = _sds((b,), torch.int32, mesh, dp)
        batch, bshard = _split(structs)
        ps, pshard, os_, oshard, opt, _g = _abstract_train_state(init, "textpair", mesh)

        def train_step(params, opt_state, bb):
            loss, _, grads = value_and_grad(
                lambda p, x: cnn_lib.loss_fn(p, x, cfg), params, bb)
            params, opt_state = opt.update(params, grads, opt_state)
            return params, opt_state, loss

        out = (pshard, oshard, NamedSharding(mesh, P()))
        return CellPlan(arch, shape.name, shape.kind, _placed(train_step, out),
                        (ps, os_, batch), (pshard, oshard, bshard), out,
                        donate=(0, 1), default_trip=1, meta={"pairs": b})

    batch, bshard = _split(structs)
    ps = init()
    pshard = SH.param_shardings(ps, "textpair", mesh)

    def serve(params, bb):
        return cnn_lib.score(params, bb["q_tok"], bb["a_tok"], bb["feats"], cfg)

    out = NamedSharding(mesh, dp)
    return CellPlan(arch, shape.name, shape.kind, _placed(serve, out), (ps, batch),
                    (pshard, bshard), out, donate=(), default_trip=1,
                    meta={"pairs": b})


# ---------------------------------------------------------------------------

def plan_cell(arch: str, shape_name: str, mesh) -> CellPlan:
    cfg = get_config(arch)
    shape = next(s for s in get_shapes(arch) if s.name == shape_name)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape_name} skipped: {why}")
    family = getattr(cfg, "family")
    return {"lm": _plan_lm, "gnn": _plan_gnn, "recsys": _plan_recsys,
            "textpair": _plan_textpair}[family](arch, cfg, shape, mesh)


def input_specs(arch: str, shape_name: str, mesh) -> Tuple[Any, ...]:
    """Meta stand-ins for every model input of the cell (their shardings
    are the plan's ``in_shardings``)."""
    return plan_cell(arch, shape_name, mesh).args
