"""RecSys models: the EmbeddingBag substrate, FM, DLRM and DIN, serving
and training.

The port of the JAX package's ``models/recsys.py``, with its names,
parameter tree and layouts. Every embedding lives in one unified table
(the fields' vocabularies one after another, padded to ``ROW_PAD`` rows);
a field's id plus the field's offset is its row.

DLRM's per-field single-hot lookup (``embedding_lookup``) runs as
``B * F`` bags of one row each on the EmbeddingBag kernel of
``kernels/embedding_bag.py`` (its plain version on CPU tensors): one launch
per ``serve_step`` and per training step, two per ``retrieval_step`` (the
user's fields, then the candidates). With weights 1 and one row a bag, the
bag is its row, bit for bit, so the kernel computes what JAX's ``jnp.take``
computes. Where the table requires a gradient the lookup is an
``EmbeddingBag`` node, whose backward is the hand-written backward kernel:
the dense table gradient summed in float32 (JAX's ``jnp.take`` VJP sums a
bfloat16 table's gradient in bfloat16; ROADMAP.md §3, reference fault 8).
The keyword ``lookup="plain"`` sends the lookups through both plain
versions instead, on any device; it exists to check the kernels against
them on the card and nothing on a user path sets it.

FM and DIN look their rows up with plain torch indexing, as the JAX code
does with ``jnp.take`` outside any Pallas kernel; the bag kernel could not
take them either (widths 10 and 18 are not multiples of its 4), and their
gradient is autograd's. ``loss_fn`` is the JAX package's binary
cross-entropy for all three.

The JAX code's ``constrain`` calls are sharding hints and are left out
until ``distributed/`` is ported. Not ported yet, and refused with
``NotImplementedError``: BERT4Rec, serving and training (ROADMAP.md §1 item
10e). Nothing here disables autograd: serving callers run under
``torch.inference_mode()``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import RecsysConfig
from repro_torch.core import export
from repro_torch.kernels.embedding_bag import embedding_bag as _bag_kernel
from repro_torch.kernels.embedding_bag import embedding_bag_plain_route
from repro_torch.models.layers import mlp_apply, mlp_params

#: rows drawn per call when the table is initialised in place, so no
#: full-size float32 copy of a 48 GB table is ever made
INIT_CHUNK_ROWS = 1 << 22
_LOOKUPS = {"kernel": _bag_kernel, "plain": embedding_bag_plain_route}


def _not_ported(cfg: RecsysConfig, what: str):
    return NotImplementedError(
        f"{cfg.name}: {what} for recsys kind {cfg.kind!r} is not ported yet "
        f"(ROADMAP.md §1 item 10e); FM, DLRM and DIN are")


def _bag(lookup: str):
    if lookup not in _LOOKUPS:
        raise ValueError(f"unknown lookup {lookup!r} (kernel or plain)")
    return _LOOKUPS[lookup]


# ---------------------------------------------------------------------------
# EmbeddingBag substrate
# ---------------------------------------------------------------------------

ROW_PAD = 512  # tables pad to a multiple of the largest mesh (shard-evenly)


def padded_rows(n: int) -> int:
    return ((n + ROW_PAD - 1) // ROW_PAD) * ROW_PAD


def field_offsets(vocab_sizes, device="cuda") -> torch.Tensor:
    """Start row of each field inside the unified table (int32)."""
    off = [0]
    for v in vocab_sizes[:-1]:
        off.append(off[-1] + v)
    return torch.tensor(off, dtype=torch.int32, device=resolve_device(device))


@functools.lru_cache(maxsize=None)
def _offsets_on(vocab_sizes, device: torch.device) -> torch.Tensor:
    """``field_offsets`` made once per device: a copy to the card on every
    step would wait for the work already queued. Callers do not write it."""
    return field_offsets(vocab_sizes, device)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     offsets: torch.Tensor, lookup: str = "kernel") -> torch.Tensor:
    """Single-hot per field: ids (B, F) -> (B, F, d), as B*F bags of one
    row (the row ``ids[b, f] + offsets[f]``)."""
    b, f = ids.shape
    gids = (ids.to(torch.int32) + offsets[None, :]).reshape(b * f, 1)
    return _bag(lookup)(table, gids).reshape(b, f, table.shape[1])


def embedding_bag(table: torch.Tensor, flat_ids: torch.Tensor,
                  segment_ids: torch.Tensor, n_bags: int,
                  weights: Optional[torch.Tensor] = None,
                  mode: str = "sum") -> torch.Tensor:
    """Ragged multi-hot bag: gather rows then segment-reduce into bags.

    flat_ids (L,), segment_ids (L,) sorted bag ids, -> (n_bags, d). Plain
    torch (no path calls it yet): sums and counts in the table's type as
    ``jax.ops.segment_sum`` keeps them; an empty bag is 0 for "sum" and
    "mean" and -inf for "max", as in JAX."""
    rows = table[flat_ids.long()]
    if weights is not None:
        rows = rows * weights[:, None]
    seg = segment_ids.long()
    shape = (n_bags, rows.shape[1])
    if mode in ("sum", "mean"):
        s = torch.zeros(shape, dtype=rows.dtype, device=rows.device).index_add_(0, seg, rows)
        if mode == "sum":
            return s
        c = torch.zeros((n_bags,), dtype=s.dtype, device=s.device).index_add_(
            0, seg, torch.ones_like(seg, dtype=s.dtype))
        return s / torch.clamp(c, min=1.0)[:, None]
    if mode == "max":
        init = torch.full(shape, float("-inf"), dtype=rows.dtype, device=rows.device)
        return init.scatter_reduce(0, seg[:, None].expand_as(rows), rows, "amax")
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# FM  — pairwise interactions via the O(nk) sum-square trick
# ---------------------------------------------------------------------------

def init_fm(generator: torch.Generator, cfg: RecsysConfig) -> Dict:
    """FM's parameters on the generator's device: the unified table ``emb``
    (padded_rows(total vocab), k) at std 0.02, the linear weights ``lin``
    (padded_rows,) at std 0.01, and the scalar ``bias`` 0 (float32)."""
    v_total = padded_rows(sum(cfg.vocab_sizes))
    dt = getattr(torch, cfg.dtype)
    dev = generator.device
    return {
        "emb": _table_init(generator, v_total, cfg.embed_dim, dt),
        "lin": (torch.randn((v_total,), generator=generator, device=dev) * 0.01).to(dt),
        "bias": torch.zeros((), dtype=torch.float32, device=dev),
    }


def _field_rows(ids: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """ids (..., F) plus each field's offset: the rows of the unified table."""
    return ids.long() + offsets


def fm_forward(params: Dict, ids: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    """ids (B, F) -> logits (B,) float32.  0.5*((Σv)² − Σv²) over fields."""
    gids = _field_rows(ids, _offsets_on(cfg.vocab_sizes, ids.device))
    v = params["emb"][gids].float()                                  # (B,F,k)
    lin = params["lin"][gids].float().sum(-1)
    sum_v = v.sum(dim=1)
    pair = 0.5 * (sum_v.square() - v.square().sum(dim=1)).sum(-1)
    return params["bias"] + lin + pair


def fm_retrieval(params: Dict, user_ids: torch.Tensor, cand_ids: torch.Tensor,
                 cfg: RecsysConfig) -> torch.Tensor:
    """Score 1 user context against N candidates in the LAST field: (B, N).

    FM decomposes: score(u, i) = const(u) + lin[i] + v_i · Σ_f v_f(u),
    so retrieval is one batched dot — O(N*k), no loop."""
    offs = _offsets_on(cfg.vocab_sizes, cand_ids.device)
    gu = _field_rows(user_ids, offs[:-1])
    vu = params["emb"][gu].float()                                   # (B,F-1,k)
    sum_u = vu.sum(dim=1)                                            # (B,k)
    const = (params["bias"] + params["lin"][gu].float().sum(-1)
             + 0.5 * (sum_u.square() - vu.square().sum(dim=1)).sum(-1))
    gc = _field_rows(cand_ids, offs[-1])
    vc = params["emb"][gc].float()                                   # (N,k)
    lin_c = params["lin"][gc].float()
    return const[:, None] + lin_c[None, :] + sum_u @ vc.T            # (B,N)


# ---------------------------------------------------------------------------
# DLRM — bottom MLP + embedding lookups + dot interaction + top MLP
# ---------------------------------------------------------------------------

def _table_init(generator: torch.Generator, rows: int, d: int,
                dtype: torch.dtype) -> torch.Tensor:
    """A (rows, d) table at std 0.02 (the JAX init's), drawn in place in
    row chunks on the generator's device: no float32 copy of the table."""
    table = torch.empty((rows, d), dtype=dtype, device=generator.device)
    for i in range(0, rows, INIT_CHUNK_ROWS):
        table[i:i + INIT_CHUNK_ROWS].normal_(0.0, 0.02, generator=generator)
    return table


def init_dlrm(generator: torch.Generator, cfg: RecsysConfig) -> Dict:
    """DLRM's parameters on the generator's device: the unified table
    ``emb`` (padded_rows(total vocab), d), and the bottom and top MLPs
    (``{"w": [...], "b": [...]}``)."""
    v_total = padded_rows(sum(cfg.vocab_sizes))
    dt = getattr(torch, cfg.dtype)
    n_f = cfg.n_sparse + 1
    d_int = n_f * (n_f - 1) // 2 + cfg.bot_mlp[-1]
    return {
        "emb": _table_init(generator, v_total, cfg.embed_dim, dt),
        "bot": mlp_params(generator, (cfg.n_dense,) + cfg.bot_mlp, dt),
        "top": mlp_params(generator, (d_int,) + cfg.top_mlp, dt),
    }


def dot_interaction(vecs: torch.Tensor) -> torch.Tensor:
    """vecs (B, F, d) -> upper-triangle of pairwise dots (B, F*(F-1)/2),
    in the row-major order of ``jnp.triu_indices(F, k=1)``."""
    z = torch.bmm(vecs, vecs.transpose(1, 2))
    f = vecs.shape[1]
    iu, ju = torch.triu_indices(f, f, 1, device=vecs.device)
    return z[:, iu, ju]


def _bottom(params: Dict, dense: torch.Tensor) -> torch.Tensor:
    return mlp_apply(params["bot"], dense.to(params["emb"].dtype), act=torch.relu,
                     final_act=torch.relu)


def dlrm_forward(params: Dict, dense: torch.Tensor, ids: torch.Tensor,
                 cfg: RecsysConfig, lookup: str = "kernel") -> torch.Tensor:
    """dense (B, 13), ids (B, 26) -> logits (B,) float32."""
    bot = _bottom(params, dense)                                     # (B,128)
    emb = embedding_lookup(params["emb"], ids,
                           _offsets_on(cfg.vocab_sizes, ids.device),
                           lookup)                                   # (B,26,128)
    vecs = torch.cat([bot[:, None, :], emb], dim=1)                  # (B,27,128)
    x = torch.cat([bot, dot_interaction(vecs)], dim=-1)
    return mlp_apply(params["top"], x)[:, 0].float()


def dlrm_retrieval(params: Dict, dense: torch.Tensor, user_ids: torch.Tensor,
                   cand_ids: torch.Tensor, cfg: RecsysConfig,
                   lookup: str = "kernel") -> torch.Tensor:
    """1 query context vs N candidates in the last sparse field.

    Decomposed as in JAX: the 25 user rows and the bottom MLP are computed
    once and broadcast into the interaction; only the candidate field
    gathers at N scale."""
    n = cand_ids.shape[0]
    offs = _offsets_on(cfg.vocab_sizes, cand_ids.device)
    bot = _bottom(params, dense)                                     # (1, d_bot)
    user_emb = embedding_lookup(params["emb"], user_ids, offs[:-1],
                                lookup)                              # (1,25,d)
    cand_emb = embedding_lookup(params["emb"], cand_ids[:, None], offs[-1:],
                                lookup)                              # (N,1,d)
    fixed = torch.cat([bot[:, None, :], user_emb], dim=1)            # (1,26,d)
    vecs = torch.cat([fixed.expand(n, -1, -1), cand_emb], dim=1)     # (N,27,d)
    x = torch.cat([bot.expand(n, -1), dot_interaction(vecs)], dim=-1)
    return mlp_apply(params["top"], x)[:, 0].float()


# ---------------------------------------------------------------------------
# DIN — target attention over user behaviour history
# ---------------------------------------------------------------------------

def init_din(generator: torch.Generator, cfg: RecsysConfig) -> Dict:
    """DIN's parameters on the generator's device: the item table ``emb``
    (padded_rows(n_items), d) at std 0.02, the attention MLP ``attn``
    (4d -> attn_mlp -> 1) and the output MLP ``out`` (2d -> mlp -> 1)."""
    dt = getattr(torch, cfg.dtype)
    d = cfg.embed_dim
    return {
        "emb": _table_init(generator, padded_rows(cfg.n_items), d, dt),
        "attn": mlp_params(generator, (4 * d,) + cfg.attn_mlp + (1,), dt),
        "out": mlp_params(generator, (2 * d,) + cfg.mlp + (1,), dt),
    }


def din_attention(params: Dict, hist_e: torch.Tensor, tgt_e: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """hist_e (B,S,d), tgt_e (B,d), mask (B,S) -> interest vector (B,d)."""
    t = tgt_e[:, None, :].expand_as(hist_e)
    a_in = torch.cat([hist_e, t, hist_e - t, hist_e * t], dim=-1)
    logits = mlp_apply(params["attn"], a_in, act=torch.sigmoid)[..., 0]
    logits = torch.where(mask > 0, logits.float(), -1e30)
    w = torch.softmax(logits, dim=-1).to(hist_e.dtype)
    return torch.einsum("bs,bsd->bd", w, hist_e)


def din_forward(params: Dict, hist: torch.Tensor, hist_mask: torch.Tensor,
                target: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    """hist (B,S) item ids, target (B,) -> logits (B,) float32."""
    he = params["emb"][hist.long()]
    te = params["emb"][target.long()]
    interest = din_attention(params, he, te, hist_mask)
    x = torch.cat([interest, te], dim=-1)
    return mlp_apply(params["out"], x)[:, 0].float()


def din_retrieval(params: Dict, hist: torch.Tensor, hist_mask: torch.Tensor,
                  cand_ids: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    """1 user history vs N candidate targets: (N,).

    The user history embeds ONCE (its S rows); only the candidate targets
    gather at N scale."""
    n = cand_ids.shape[0]
    he = params["emb"][hist.long()]                                  # (1,S,d)
    te = params["emb"][cand_ids.long()]                              # (N,d)
    he_b = he.expand(n, -1, -1)
    mask_b = hist_mask.expand(n, -1)
    interest = din_attention(params, he_b, te, mask_b)
    x = torch.cat([interest, te], dim=-1)
    return mlp_apply(params["out"], x)[:, 0].float()


# ---------------------------------------------------------------------------
# Unified dispatch
# ---------------------------------------------------------------------------

def init_model(cfg: RecsysConfig, generator: torch.Generator,
               device="cuda") -> Dict:
    """Random parameters with the JAX init's distributions (tables at std
    0.02, dense layers at std 1/sqrt(fan_in), biases 0; FM's ``lin`` at std
    0.01), drawn from ``generator`` on ``device``, which must be the
    generator's own: a full-width table (48 GB in bfloat16 for dlrm-mlperf)
    is drawn where it lives, never moved."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"draw on {dev.type} with a {dev.type} generator, not "
                         f"{generator.device.type}: the table is drawn in place")
    inits = {"fm": init_fm, "dlrm": init_dlrm, "din": init_din}
    if cfg.kind not in inits:
        raise _not_ported(cfg, "init_model")
    return inits[cfg.kind](generator, cfg)


def params_from_numpy(tree, device="cuda"):
    """The JAX parameter tree (nested dicts and lists of numpy arrays, or
    of tensors; the MLPs' ``w``/``b`` are lists) as the port's parameters:
    the same nesting, contiguous tensors of the same dtype on ``device``
    (bfloat16 arrays stay bfloat16)."""
    return export.to_torch(tree, device)


def _logits(params: Dict, batch: Dict, cfg: RecsysConfig, lookup: str,
            what: str) -> torch.Tensor:
    """The CTR models' logits (B,) float32 of a batch; ``lookup`` picks
    DLRM's lookup route (FM and DIN index plainly)."""
    if cfg.kind == "fm":
        return fm_forward(params, batch["ids"], cfg)
    if cfg.kind == "dlrm":
        return dlrm_forward(params, batch["dense"], batch["ids"], cfg, lookup)
    if cfg.kind == "din":
        return din_forward(params, batch["hist"], batch["hist_mask"], batch["target"], cfg)
    raise _not_ported(cfg, what)


def loss_fn(params: Dict, batch: Dict, cfg: RecsysConfig,
            lookup: str = "kernel") -> Tuple[torch.Tensor, Dict]:
    """Binary cross-entropy of the CTR models, the JAX formula: the stable
    ``max(x, 0) - x y + log1p(exp(-|x|))`` on float32 logits, averaged;
    metrics ``bce`` and ``acc``. BERT4Rec's sampled softmax is not ported."""
    logits = _logits(params, batch, cfg, lookup, "loss_fn")
    y = batch["label"].float()
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))
    acc = torch.mean(((logits > 0) == (y > 0.5)).float())
    return loss, {"bce": loss, "acc": acc}


def serve_step(params: Dict, batch: Dict, cfg: RecsysConfig,
               lookup: str = "kernel") -> torch.Tensor:
    """Scores of a request batch (B,): DLRM {"dense" (B, 13), "ids" (B, 26)},
    FM {"ids" (B, F)}, DIN {"hist" (B, S), "hist_mask" (B, S), "target" (B,)}."""
    return _logits(params, batch, cfg, lookup, "serve_step")


def retrieval_step(params: Dict, batch: Dict, cfg: RecsysConfig,
                   lookup: str = "kernel") -> torch.Tensor:
    """One query context vs N candidates: DLRM {"dense" (1, 13), "user_ids"
    (1, 25), "candidates" (N,)} -> (N,); FM {"user_ids" (1, F-1),
    "candidates"} -> (1, N); DIN {"hist" (1, S), "hist_mask" (1, S),
    "candidates"} -> (N,)."""
    if cfg.kind == "fm":
        return fm_retrieval(params, batch["user_ids"], batch["candidates"], cfg)
    if cfg.kind == "dlrm":
        return dlrm_retrieval(params, batch["dense"], batch["user_ids"],
                              batch["candidates"], cfg, lookup)
    if cfg.kind == "din":
        return din_retrieval(params, batch["hist"], batch["hist_mask"],
                             batch["candidates"], cfg)
    raise _not_ported(cfg, "retrieval_step")
