"""Foundational layers: RMS and layer norm, RoPE, GQA attention, SwiGLU,
MLPs, inits, the LM's cross-entropy.

The LM subset of the JAX package's ``models/layers.py``, its plain MLP
stack (the recsys models') and its layer norm (BERT4Rec's and the GNN's),
as pure functions
over plain dicts of tensors, with the same names, layouts and order of
float32 casts: ``q (B, S, H, D)``, ``k/v (B, S, Hkv, D)``, query head ``h``
on KV head ``h // G`` with ``G = H / Hkv``. Initializers draw from an
explicit ``torch.Generator`` (on its own device) with the JAX package's
distributions; the numbers differ from ``jax.random``'s, so tests that need
the same weights in both packages move them with ``params_from_numpy``.

Products that JAX writes with ``preferred_element_type=float32`` run here
on float32 copies of their operands: the products of bfloat16 values are
exact in float32, so the sums are float32 sums in both packages.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import randn
from repro_torch.distributed.sharding import block_index, by_rows, is_dtensor, split_dims

#: the mask value of every attention here: exp(-1e30 - m) is 0 without NaN
#: where a whole row of a tile is masked, unlike -inf
MASK = -1e30


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    return (randn((d_in, d_out), generator) / math.sqrt(d_in)).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return (randn((vocab, d), generator) * 0.02).to(dtype)


def mlp_params(generator: torch.Generator, dims: Tuple[int, ...],
               dtype=torch.float32) -> Dict:
    """Plain MLP param stack: dims = (in, h1, ..., out); weights (in, out)
    at std 1/sqrt(in), biases zero, as lists ``{"w": [...], "b": [...]}``."""
    ws, bs = [], []
    for a, b in zip(dims[:-1], dims[1:]):
        ws.append(dense_init(generator, a, b, dtype))
        bs.append(torch.zeros((b,), dtype=dtype, device=generator.device))
    return {"w": ws, "b": bs}


def mlp_apply(params: Dict, x: torch.Tensor, act=torch.relu,
              final_act=None) -> torch.Tensor:
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        x = x @ w + b
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis in float32, cast back to x's type: the
    JAX formula, ``(x - mean) * rsqrt(var + eps) * w + b`` with the biased
    variance ``mean((x - mean)^2)``."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_table(positions: torch.Tensor, d_head: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions: (..., d_head//2), float32.

    The frequencies are ``exp(-log(theta) * i / half)`` in float32, as the
    JAX package computes them (``theta ** (-i / half)`` rounds otherwise)."""
    half = d_head // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, d_head); cos/sin: (..., seq, d_head//2).

    Half-split rotation: the first half of each head pairs with the second
    (not interleaved pairs)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# attention (GQA)
# ---------------------------------------------------------------------------

def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     chunk: int = 512) -> torch.Tensor:
    """Memory-bounded GQA causal attention in plain torch (``attn_impl=
    "chunked"``).

    q: (B, S, H, D); k,v: (B, S, Hkv, D). Grouped einsums keep K/V at Hkv
    heads; query chunks of ``chunk`` rows bound the live score buffer to
    (B, Hkv, G, chunk, S). As in the JAX package, S above ``chunk`` must be
    a multiple of it.
    """
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    kv_pos = torch.arange(s, device=q.device)
    kf = k.float()

    def attend(qc: torch.Tensor, q_pos: torch.Tensor) -> torch.Tensor:
        # qc: (B, C, Hkv, G, D) -> out (B, C, Hkv, G, D)
        scores = torch.einsum("bckgd,bskd->bkgcs", qc.float(), kf) * scale
        mask = kv_pos[None, :] <= q_pos[:, None]
        scores = torch.where(mask, scores, MASK)
        p = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bkgcs,bskd->bckgd", p, v)

    qg = _whole_heads(q, 2, hkv).reshape(b, s, hkv, g, d)
    if s <= chunk:
        return attend(qg, kv_pos).reshape(b, s, h, d)
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    out = [attend(qg[:, i:i + chunk], kv_pos[i:i + chunk])
           for i in range(0, s, chunk)]
    return torch.cat(out, dim=1).reshape(b, s, h, d)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token GQA decode attention.

    q: (B, 1, H, D); caches: (B, S, Hkv, D). ``kv_len`` (B,) masks each
    row's positions ``>= kv_len``. Grouped einsum: the cache is read at Hkv
    heads, never repeated to H.
    """
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    g = h // hkv
    s = k_cache.shape[1]
    scale = 1.0 / math.sqrt(d)
    # a DTensor query's heads whole: the products flatten (B, Hkv), which
    # DTensor cannot split on both
    qg = _whole_heads(q, 2, 1).reshape(b, hkv, g, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    if kv_len is not None:
        mask = (torch.arange(s, device=q.device)[None, None, None, :]
                < kv_len[:, None, None, None])
        scores = torch.where(mask, scores, MASK)
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache)
    return out.reshape(b, 1, h, d)


# ---------------------------------------------------------------------------
# transformer sublayers (params + apply)
# ---------------------------------------------------------------------------

def attn_params(generator: torch.Generator, d_model: int, n_heads: int, n_kv: int,
                d_head: int, qk_norm: bool, dtype) -> Dict:
    p = {
        "wq": dense_init(generator, d_model, n_heads * d_head, dtype),
        "wk": dense_init(generator, d_model, n_kv * d_head, dtype),
        "wv": dense_init(generator, d_model, n_kv * d_head, dtype),
        "wo": dense_init(generator, n_heads * d_head, d_model, dtype),
    }
    if qk_norm:
        p["q_norm"] = torch.ones((d_head,), dtype=dtype, device=generator.device)
        p["k_norm"] = torch.ones((d_head,), dtype=dtype, device=generator.device)
    return p


def split_heads(t: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n * d) -> (..., n, d). A DTensor whose last dim is split over
    mesh dims whose ranks do not divide ``n`` (8 KV heads over 16 ranks)
    is gathered along that dim first: a head is never cut."""
    if is_dtensor(t):
        t = _whole_heads(t, t.ndim - 1, n)
    return t.reshape(*t.shape[:-1], n, d)


def _whole_heads(t, dim: int, n: int):
    """DTensor ``t`` gathered along ``dim`` unless the ranks that split it
    divide ``n``; anything else as it is."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(t):
        return t
    split = split_dims(t, dim)
    ranks = 1
    for i in split:
        ranks *= t.device_mesh.size(i)
    if n % ranks == 0:
        return t
    return t.redistribute(t.device_mesh, tuple(Replicate() if i in split else pl
                                              for i, pl in enumerate(t.placements)))


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``. DTensor ids (a planned step's) run on each rank's
    own rows with the table gathered whole, its gradient reduced back onto
    its layout (``sharding.by_rows``): an index with DTensor operands has
    no reliable rule in DTensor."""
    if is_dtensor(ids):
        return by_rows(lambda i, t: t[i.long()], ids, table)
    return table[ids.long()]


def seq_whole(x):
    """A DTensor (B, S, ...) with its sequence gathered where it is split
    (the sequence-parallel residual before a product with weights:
    Megatron-SP's all-gather, which XLA's partitioner inserts in the JAX
    package); anything else as it is."""
    if not is_dtensor(x):
        return x
    split = split_dims(x, 1)
    if not split:
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if i in split else pl
                                         for i, pl in enumerate(x.placements)])


def qkv_project(p: Dict, x: torch.Tensor, n_heads: int, n_kv: int, d_head: int,
                positions: torch.Tensor, theta: float):
    """x (B, S, d_model) -> q (B, S, H, D), k, v (B, S, Hkv, D); q_norm and
    k_norm (qk_norm) apply before the rotation."""
    x = seq_whole(x)
    q = split_heads(x @ p["wq"], n_heads, d_head)
    k = split_heads(x @ p["wk"], n_kv, d_head)
    v = split_heads(x @ p["wv"], n_kv, d_head)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    cos, sin = rope_table(positions, d_head, theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


def swiglu_params(generator: torch.Generator, d_model: int, d_ff: int, dtype) -> Dict:
    return {
        "w_gate": dense_init(generator, d_model, d_ff, dtype),
        "w_up": dense_init(generator, d_model, d_ff, dtype),
        "w_down": dense_init(generator, d_ff, d_model, dtype),
    }


def swiglu_apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    x = seq_whole(x)
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy in float32 with optional z-loss: the mean
    over tokens of ``lse - logits[label]`` (+ ``z_loss * lse**2``), ``lse``
    the log-sum-exp over the vocab.

    The JAX package picks the label's logit with a sum over a vocab-wide
    ``where`` (no gather), for vocab-sharded SPMD; on one card
    ``torch.gather`` picks the same value (that sum adds zeros to it)
    without a (B, S, V) index tensor, and ``torch.logsumexp`` subtracts the
    row max as the JAX function does. DTensor logits (vocab-sharded in a
    planned step) stay sharded: the log-sum-exp as the row max (of the
    detached logits) plus the log of a sum of exponentials, each reduced
    over the ranks that split the vocab, and the label's logit as JAX's
    ``where`` sum, which each rank runs on its own vocab columns
    (``_label_logit``)."""
    logits = logits.float()
    if not is_dtensor(logits):
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        m = logits.detach().amax(dim=-1, keepdim=True)
        lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(-1))
        ll = _label_logit(logits, labels)
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return torch.mean(loss)


def _label_logit(logits, labels):
    """``logits[..., labels]`` of vocab-sharded DTensor logits: each rank
    sums its own columns where the label falls (JAX's ``where`` sum over
    the vocab, its iota offset by the rank's first column), and the sums
    are ``Partial`` over the mesh dims that split the vocab."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    place = [pl if isinstance(pl, Shard) else Replicate() for pl in logits.placements]
    vocab = split_dims(logits, logits.ndim - 1)
    rows = [Replicate() if i in vocab else pl for i, pl in enumerate(place)]
    out = [Partial() if i in vocab else pl for i, pl in enumerate(rows)]

    def local(lg, lab):
        lo = block_index(mesh, vocab) * lg.shape[-1]
        iota = torch.arange(lo, lo + lg.shape[-1], device=lg.device)
        return torch.where(iota == lab.long()[..., None], lg, 0.0).sum(-1)

    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return local_map(local, out_placements=out, in_placements=(place, rows),
                     device_mesh=mesh, redistribute_inputs=True)(logits, labels)
