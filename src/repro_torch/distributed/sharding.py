"""Per-architecture sharding rules: param specs, optimizer ZeRO sharding,
input/output specs. Pattern-matching on param tree paths keeps the rules in
ONE place; everything else (models, optimizers) stays sharding-agnostic.

The port of the JAX package's ``distributed/sharding.py``, rule for rule:

LM      : Megatron-style TP over 'model' (heads / ffn / vocab), batch over
          ('pod','data'); optimizer state additionally ZeRO-sharded over the
          data axes (largest divisible dim).
MoE     : experts over 'model' (EP); router replicated; shared expert TP.
GNN     : edges over ALL axes (1D edge partition), nodes replicated.
RecSys  : embedding tables row-sharded over ALL axes (the tables are the
          model); MLPs replicated; batch over data axes.
TextPair: replicated params, batch over data axes.

A spec is ``P``, the twin of ``jax.sharding.PartitionSpec``: one entry a
tensor dim, each ``None``, an axis name or a tuple of axis names. The rules
read a leaf's path (``core.treepath.keystr``) and shape and the mesh's axis
sizes only, so they run on an ``AbstractMesh`` as on a ``DeviceMesh``.
``placements(spec, mesh)`` turns a spec into DTensor placements, in place of
JAX's ``NamedSharding``, and ``distribute`` places a tree by its specs.
``NamedSharding(mesh, spec)`` keeps a spec beside its mesh and its
placements; ``named`` and ``param_shardings`` make trees of them, as JAX's
do of its own.
"""
from __future__ import annotations

import re
from typing import Any, Tuple

import torch

from repro_torch.core.treepath import keystr, tree_map, tree_map_with_path
from repro_torch.distributed.mesh import axis_size, data_axes, mesh_shape


class P(tuple):
    """A partition spec: one entry a tensor dim (``None``, an axis name or a
    tuple of axis names). A one-name tuple is that name, as in JAX; two
    specs are equal exactly when their entries are, so ``P("a", None) !=
    P("a")``, as JAX's are in jax 0.9."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P({', '.join(repr(e) for e in self)})"


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _dp(mesh) -> Tuple[str, ...]:
    return data_axes(mesh)


def _div(n: int, mesh, *axes) -> bool:
    return n % axis_size(mesh, *axes) == 0


# ---------------------------------------------------------------------------
# LM rules (path regex -> spec builder)
# ---------------------------------------------------------------------------

def _lm_fsdp_spec(path: str, shape, mesh) -> P:
    """FSDP: every weight matrix sharded over ALL mesh axes on its largest
    divisible dim; vocab tensors over 'model' only (aligned with the logits
    rule); a matrix no dim of which divides the whole mesh falls back to the
    data axes."""
    if re.search(r"norm", path) or not shape:
        return P(*([None] * len(shape)))
    if re.search(r"embed$", path):
        return P("model" if shape[0] % axis_size(mesh, "model") == 0 else None,
                 None)
    if re.search(r"lm_head$", path):
        return P(None,
                 "model" if shape[1] % axis_size(mesh, "model") == 0 else None)
    every = tuple(mesh_shape(mesh))
    n = axis_size(mesh, *every)
    entries = [None] * len(shape)
    best, best_dim = -1, -1
    for i, dim in enumerate(shape):
        if dim % n == 0 and dim > best:
            best, best_dim = dim, i
    if best_dim >= 0:
        entries[best_dim] = every
        return P(*entries)
    dp = _dp(mesh)
    ndp = axis_size(mesh, *dp)
    for i, dim in enumerate(shape):
        if dim % ndp == 0 and dim > best:
            best, best_dim = dim, i
    if best_dim >= 0:
        entries[best_dim] = dp if len(dp) > 1 else dp[0]
    return P(*entries)


def _lm_spec(path: str, shape, mesh) -> P:
    m = "model"
    rules = [
        (r"embed$", P(m, None)),
        (r"lm_head$", P(None, m)),
        (r"layers/attn/wq$", P(None, None, m)),
        (r"layers/attn/wk$", P(None, None, m) if _div(shape[-1], mesh, m) else P(None, None, None)),
        (r"layers/attn/wv$", P(None, None, m) if _div(shape[-1], mesh, m) else P(None, None, None)),
        (r"layers/attn/wo$", P(None, m, None)),
        (r"layers/attn/(q|k)_norm$", P(None, None)),
        (r"layers/(attn_norm|mlp_norm)$", P(None, None)),
        (r"layers/mlp/w_(gate|up)$", P(None, None, m)),
        (r"layers/mlp/w_down$", P(None, m, None)),
        (r"layers/moe/router$", P(None, None, None)),
        (r"layers/moe/w_(gate|up)$", P(None, m, None, None)),   # (L,E,d,de): EP
        (r"layers/moe/w_down$", P(None, m, None, None)),
        (r"layers/moe/shared/w_(gate|up)$", P(None, None, m)),
        (r"layers/moe/shared/w_down$", P(None, m, None)),
        (r"final_norm$", P(None)),
    ]
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return P(*([None] * len(shape)))


def _gnn_spec(path: str, shape, mesh) -> P:
    return P(*([None] * len(shape)))  # GNN MLPs are tiny: replicate


def _recsys_spec(path: str, shape, mesh) -> P:
    every = tuple(mesh_shape(mesh))
    if re.search(r"(^|/)(emb|lin)$", path) and shape and _div(shape[0], mesh, *every):
        # the big tables: row-shard over the whole mesh
        return P(every, *([None] * (len(shape) - 1)))
    return P(*([None] * len(shape)))


def _textpair_spec(path: str, shape, mesh) -> P:
    return P(*([None] * len(shape)))


_FAMILY_RULES = {
    "lm": _lm_spec,
    "lm_fsdp": _lm_fsdp_spec,
    "gnn": _gnn_spec,
    "recsys": _recsys_spec,
    "textpair": _textpair_spec,
}


def param_specs(params: Any, family: str, mesh) -> Any:
    """A tree of ``P`` matching ``params`` (leaves read for their shape
    only: tensors, meta tensors or anything with ``.shape``)."""
    rule = _FAMILY_RULES[family]
    return tree_map_with_path(lambda path, leaf: rule(keystr(path), _shape(leaf), mesh),
                               params)


def param_shardings(params: Any, family: str, mesh) -> Any:
    """``param_specs`` as a tree of ``NamedSharding`` on ``mesh``."""
    return named(mesh, param_specs(params, family, mesh))


# ---------------------------------------------------------------------------
# optimizer-state sharding: ZeRO over the data axes
# ---------------------------------------------------------------------------

def zero_shard_spec(spec: P, shape, mesh) -> P:
    """Additionally shard the largest yet-unsharded dim over the data axes
    (ZeRO-1: master weights + moments live sharded), unless the spec
    already uses a data axis."""
    dp = _dp(mesh)
    if not dp:
        return spec
    used = {a for e in spec for a in _axes(e)}
    if used & set(dp):
        return spec  # data axes already consumed by this param's spec
    dp_size = axis_size(mesh, *dp)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = -1, -1
    for i, (e, n) in enumerate(zip(entries, shape)):
        if e is None and n % dp_size == 0 and n > best:
            best, best_dim = n, i
    if best_dim >= 0:
        entries[best_dim] = dp if len(dp) > 1 else dp[0]
    return P(*entries)


def opt_state_specs(opt_state: Any, params: Any, family: str, mesh) -> Any:
    """Specs for {step, mu, nu, master} (adamw) / {step, vel, master} (sgd):
    moments & master follow the ZeRO-extended param spec; ``step`` is
    ``P()``."""
    pspecs = param_specs(params, family, mesh)
    return {k: P() if k == "step" else
            tree_map(lambda leaf, spec: zero_shard_spec(spec, _shape(leaf), mesh), v, pspecs)
            for k, v in opt_state.items()}


# ---------------------------------------------------------------------------
# batch/input specs per family+kind
# ---------------------------------------------------------------------------

def batch_specs(batch: Any, family: str, kind: str, mesh) -> Any:
    dp = _dp(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    every = tuple(mesh_shape(mesh))

    if family == "recsys" and kind in ("rec_train", "rec_serve"):
        # recsys MLPs are replicated (tables shard rows over the full mesh),
        # so the batch shards over EVERY axis where it divides
        def rec_default(path, leaf):
            shape = _shape(leaf)
            if not shape:
                return P()
            ax = every if shape[0] % axis_size(mesh, *every) == 0 else dpa
            return P(ax, *([None] * (len(shape) - 1)))
        return tree_map_with_path(rec_default, batch)

    def default(path, leaf):
        nd = len(_shape(leaf))
        return P(dpa, *([None] * (nd - 1))) if nd else P()

    if family == "gnn" and kind in ("graph_full", "graph_sampled"):
        # edges over ALL axes, node arrays replicated
        def gnn_rule(path, leaf):
            nd = len(_shape(leaf))
            if re.search(r"(edges|senders|receivers|edge_mask)$", keystr(path)):
                return P(every, *([None] * (nd - 1)))
            return P(*([None] * nd))
        return tree_map_with_path(gnn_rule, batch)

    if family == "recsys" and kind == "rec_retrieval":
        def rec_rule(path, leaf):
            nd = len(_shape(leaf))
            if re.search(r"candidates$", keystr(path)):
                return P(every, *([None] * (nd - 1)))
            return P(*([None] * nd))  # the single query context: replicated
        return tree_map_with_path(rec_rule, batch)

    return tree_map_with_path(default, batch)


def cache_specs(cache: Any, cfg, mesh) -> Any:
    """KV cache (L, B, S, Hkv, Dh) [+ (L, B, S, Hkv) int8 scales]: batch
    over data axes; SEQUENCE over 'model' where it divides (kv heads rarely
    divide 16)."""
    dp = _dp(mesh)
    dpa = dp if len(dp) > 1 else dp[0]

    def one(path, leaf):
        shape = _shape(leaf)
        seq_ax = "model" if shape[2] % axis_size(mesh, "model") == 0 else None
        return P(None, dpa, seq_ax, *([None] * (len(shape) - 3)))
    return tree_map_with_path(one, cache)


# ---------------------------------------------------------------------------
# placing tensors: DTensor placements in place of NamedSharding
# ---------------------------------------------------------------------------

def placements(spec: P, mesh) -> tuple:
    """One DTensor placement a mesh dim: ``Shard(d)`` where tensor dim d's
    entry names that axis, ``Replicate()`` elsewhere. A dim sharded over a
    tuple of axes is ``Shard(d)`` on each of them; DTensor cuts such a dim
    by the mesh dims in mesh order, the first the outermost, which is JAX's
    order for a tuple in mesh order, so a tuple in any other order
    raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} of dim {d} are not in the mesh's "
                             f"order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: axis {names[i]!r} shards two dims")
            out[i] = Shard(d)
    return tuple(out)


class NamedSharding:
    """A spec on a mesh, the twin of JAX's ``NamedSharding``: ``.mesh``,
    ``.spec`` (a ``P``) and ``.placements``, the spec's DTensor placements
    on the mesh (a ``DeviceMesh`` or an ``AbstractMesh``). Two are equal
    when their specs and their meshes' axes are."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and self.spec == other.spec
                and mesh_shape(self.mesh) == mesh_shape(other.mesh))

    def __hash__(self) -> int:
        return hash((self.spec, tuple(mesh_shape(self.mesh).items())))

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


def named(mesh, tree_of_specs: Any) -> Any:
    """A tree of ``P`` as a tree of ``NamedSharding`` on ``mesh`` (a ``P``
    is a tuple, so it is a leaf here, not a node)."""
    if isinstance(tree_of_specs, P):
        return NamedSharding(mesh, tree_of_specs)
    if isinstance(tree_of_specs, dict):
        return {k: named(mesh, v) for k, v in tree_of_specs.items()}
    if isinstance(tree_of_specs, (list, tuple)):
        return [named(mesh, v) for v in tree_of_specs]
    raise TypeError(f"not a tree of specs: {type(tree_of_specs).__name__}")


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (a planned step's), without importing
    DTensor for a plain tensor."""
    if type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def split_dims(t, dim: int) -> list:
    """The mesh dims over which DTensor ``t`` splits its tensor dim ``dim``,
    in mesh order."""
    from torch.distributed.tensor import Shard
    return [i for i, pl in enumerate(t.placements) if isinstance(pl, Shard) and pl.dim == dim]


def block_index(mesh, dims) -> int:
    """This rank's block of a tensor dim split over mesh dims ``dims`` (the
    first the outermost, as DTensor cuts it)."""
    block = 0
    for i in dims:
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    return block


def by_rows(fn, x, *params):
    """``fn(x, *params)`` of a DTensor ``x`` whose rows (dim 0) are
    independent, on each rank's own rows through ``local_map``: x keeps
    its split by rows (gathered on any other dim), the params (DTensors or
    plain tensors) are gathered whole, and their gradient is each rank's
    share, ``Partial`` over the mesh dims that split the rows. The output
    is split by rows as x."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    rows = split_dims(x, 0)
    x_place = [Shard(0) if i in rows else Replicate() for i in range(mesh.ndim)]
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if i in rows else Replicate() for i in range(mesh.ndim)]
    params = [p if isinstance(p, DTensor) else DTensor.from_local(p, mesh, whole, run_check=False)
              for p in params]
    return local_map(fn, out_placements=x_place,
                     in_placements=(x_place, *[whole] * len(params)),
                     in_grad_placements=(x_place, *[grad] * len(params)),
                     device_mesh=mesh, redistribute_inputs=True)(x, *params)


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """``tree``'s tensors as DTensors on ``mesh`` (a ``DeviceMesh``), each
    placed by its spec in ``specs`` (a tree of ``P`` of the same
    structure): every rank keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map(lambda t, spec: distribute_tensor(t, mesh, placements(spec, mesh)),
                    tree, specs)
