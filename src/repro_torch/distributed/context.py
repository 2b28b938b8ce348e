"""Activation-sharding context: lets pure model code place sharding
constraints without threading a mesh through every call.

The port of the JAX package's ``distributed/context.py``. Model code calls
``constrain(x, kind)``; outside a context, or on a plain tensor, it is the
identity; inside a context, on a DTensor, it redistributes ``x`` to the
placements of the rule registered for ``kind`` (``sharding.placements``),
skipping a rule whose axes do not divide ``x``'s dims, as JAX's
``with_sharding_constraint`` under the same rule would be skipped. The
context is a ``contextvars.ContextVar``: it holds in the thread (and task)
that entered it, so code that runs a model's layers elsewhere (a
rematerialised layer's recompute in the backward) captures ``current()``
and enters it again there. Under ``fsdp`` (the planner's dense LM
training) a model gathers each layer's weights whole before running it
(``gather_layer``), where JAX leaves that all-gather to XLA.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict

from repro_torch.distributed.mesh import data_axes, mesh_shape
from repro_torch.distributed.sharding import P, placements

_CTX: contextvars.ContextVar = contextvars.ContextVar("sharding_ctx",
                                                      default=None)


@dataclasses.dataclass
class ShardingRules:
    mesh: object
    rules: Dict[str, P]
    moe_a2a: bool = False       # route MoE through the all-to-all (moe_apply_a2a)
    fsdp: bool = False          # gather each layer's weights whole before it runs


@contextlib.contextmanager
def activation_sharding(mesh, rules: Dict[str, P], moe_a2a: bool = False,
                        fsdp: bool = False):
    tok = _CTX.set(ShardingRules(mesh, rules, moe_a2a, fsdp))
    try:
        yield
    finally:
        _CTX.reset(tok)


def current():
    return _CTX.get()


def _fits(spec: P, shape) -> bool:
    sizes = mesh_shape(_CTX.get().mesh)
    for dim, entry in zip(shape, spec):
        if entry is None:
            continue
        n = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            n *= sizes[a]
        if dim % n != 0:
            return False
    return True


def constrain(x, kind: str):
    """Apply the sharding rule registered for ``kind`` to a DTensor
    (identity outside a context, on a plain tensor, or where the rule does
    not fit ``x``)."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = ctx.rules.get(kind)
    if spec is None or len(spec) > x.ndim or not _fits(spec, x.shape):
        return x
    return x.redistribute(ctx.mesh, placements(spec, ctx.mesh))


def gather_layer(tree):
    """A layer's weights as it runs under the context: with ``fsdp`` set
    (the FSDP layout of dense LM training), each DTensor leaf gathered
    whole, the all-gather XLA's partitioner puts before the layer in the
    JAX package; its gradient comes back reduce-scattered onto the leaf's
    layout. Otherwise, or on plain tensors, the tree as it is."""
    ctx = _CTX.get()
    if ctx is None or not ctx.fsdp:
        return tree
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(tree, dict):
        return {k: gather_layer(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return tree.redistribute(tree.device_mesh, [Replicate()] * tree.device_mesh.ndim)
    return tree


def gnn_rules(mesh) -> Dict[str, P]:
    """Full-graph cells: node-latent rows shard over 'model'; edges shard
    over the data axes (set by the batch specs)."""
    return {"nodes": P("model", None)}


def recsys_rules(mesh) -> Dict[str, P]:
    """Retrieval: per-candidate tensors shard their leading dim over the
    WHOLE mesh (candidate parallelism)."""
    every = tuple(mesh_shape(mesh))
    return {"candidates": P(every)}


def lm_rules(mesh, sequence_parallel: bool = True) -> Dict[str, P]:
    dp = data_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    rules = {
        # gather sequence before the head matmul so logits shard over vocab
        "pre_logits": P(dpa, None, None),
        "logits": P(dpa, None, "model"),
        "logits_2d": P(dpa, "model"),
    }
    if sequence_parallel:
        rules["residual"] = P(dpa, "model", None)
    else:
        rules["residual"] = P(dpa, None, None)
    return rules
