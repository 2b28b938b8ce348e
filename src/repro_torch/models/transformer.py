"""Decoder-only LM: dense or MoE, GQA + RoPE (+qk_norm), a loop over stacked
layers.

The port of the JAX package's ``models/transformer.py``, with its names,
parameter tree and layouts:

  forward      tokens (B, S) -> (logits (B, S, V), moe_aux)
  loss_fn      (loss, {"ce", "moe_aux"}): next-token cross-entropy with
               z-loss 1e-4 (training)
  make_train_step  f(params, opt_state, batch) -> (params, opt_state, metrics)
  prefill      full pass that also materializes the KV cache:
               (last-position logits (B, V), {k, v: (L, B, S, Hkv, Dh)})
  init_cache   a zero cache {k, v: (L, B, max_len, Hkv, Dh)}; with
               ``cfg.kv_quant`` int8 k, v and float32 k_scale, v_scale
               (L, B, max_len, Hkv)
  decode_step  one new token per row against the cache

Layer parameters are stacked on a leading L axis, as in JAX; ``lax.scan``
becomes a Python loop over the layer index that takes views of the stacked
tensors, never copies. With ``attn_impl="flash"`` every full-sequence layer
runs its attention on the CUDA kernel of ``kernels/flash_attention.py`` (the
plain version on CPU tensors); ``"chunked"`` runs ``layers.causal_attention``
in plain torch. Decode attention is plain torch, as the JAX package leaves
it to XLA. An MoE config (``cfg.moe``) puts ``models/moe.py``'s gather
formulation in place of the dense FFN, in every pass; ``forward`` returns
the sum of the layers' load-balance losses, which ``loss_fn`` adds.

The sharding context (``distributed/context.py``) reaches the model at
JAX's places: ``constrain`` on the embedded input, on the residual stream
after each block's attention and after its FFN, and on the logits (an
identity on plain tensors); under ``activation_sharding(...,
moe_a2a=True)`` an MoE layer runs ``moe.moe_apply_a2a`` on the context's
mesh in ``forward``, ``loss_fn`` and ``prefill``, remat's recompute under
the same context, while ``decode_step`` runs ``moe_apply`` under any
context, as JAX's does. A planned step (``launch/specs.py``) runs these
passes on DTensors: under the context's ``fsdp`` each layer's weights are
gathered before it runs (``context.gather_layer``), ``prefill`` stacks the
layers' K/V, and ``decode_step`` writes each rank's block of the cache
(``_write_rows``).

Training differentiates ``forward`` with autograd. Under ``"flash"`` the
attention's gradient is the attention module's own backward
(``FlashAttention``: the CUDA backward kernel on the card, the plain
backward on the CPU), the port of ``flash_attention_jnp``'s custom VJP, so
every parameter gets its gradient and no (S, S) scores are kept; an MoE
layer's is autograd's through ``moe.moe_apply`` (each layer's router and
shared experts among the leaves). With
``cfg.remat`` (every LM config's default) each layer is rematerialised, the
twin of the JAX package's ``jax.checkpoint``: ``forward`` keeps only each
layer's input and runs the layer again in the backward
(``torch.utils.checkpoint``, non-reentrant), so a training step runs the
attention forward twice a layer and its backward once; the values are the
same as without it, an MoE layer's recomputed routing included. Remat acts only where grad is enabled: ``prefill`` and
serving run under ``torch.inference_mode()`` and keep nothing.

The int8 KV cache (``cfg.kv_quant``) is JAX's, KIVI-style: each new
(token, head) row is stored as int8 with its float32 absmax scale
(``_kv_quantize``), and each decode step dequantizes the layer's whole
cache to the model's dtype (``_kv_dequantize``) before the plain decode
attention, in JAX's order of float32 operations, so the values are JAX's
to the bit. ``forward`` and ``prefill`` ignore it, as in JAX: a prefill's
cache is in the model's dtype. Nothing here disables autograd: serving
callers run under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import init_generator, resolve_device
from repro_torch.configs.base import LMConfig
from repro_torch.core import export
from repro_torch.distributed import context as shctx
from repro_torch.distributed.context import constrain
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.training.train_loop import value_and_grad


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _attend(cfg: LMConfig, q, k, v):
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v)
    if cfg.attn_impl == "chunked":
        return L.causal_attention(q, k, v, chunk=cfg.attn_chunk)
    raise ValueError(f"unknown attn_impl {cfg.attn_impl!r} (flash or chunked)")


def _mask_padded_vocab(logits: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """-1e30 at padded vocab columns (Megatron vocab padding)."""
    if cfg.vocab_padded == cfg.vocab_size:
        return logits
    iota = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(iota < cfg.vocab_size, logits, L.MASK)


def _layer(tree, i: int):
    """Layer ``i`` of the stacked layer tree: views, not copies."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _head(params: Dict) -> torch.Tensor:
    head = params.get("lm_head")
    return params["embed"].T if head is None else head


def _ffn(cfg: LMConfig, lp: Dict, h: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's FFN on its normed input: (y, moe_aux); moe_aux is None
    for a dense layer. An MoE layer picks its strategy from the sharding
    context, as JAX's ``_moe`` does: the all-to-all expert parallelism
    (``moe.moe_apply_a2a`` on the context's mesh) under
    ``activation_sharding(..., moe_a2a=True)``, the gather formulation
    elsewhere."""
    if cfg.moe is None:
        return L.swiglu_apply(lp["mlp"], h), None
    ctx = shctx.current()
    if ctx is not None and ctx.moe_a2a:
        return moe.moe_apply_a2a(lp["moe"], h, cfg, ctx.mesh)
    return moe.moe_apply(lp["moe"], h, cfg)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_layer(generator: torch.Generator, cfg: LMConfig) -> Dict:
    dt = _dtype(cfg)
    ones = torch.ones((cfg.d_model,), dtype=dt, device=generator.device)
    p = {
        "attn": L.attn_params(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.d_head, cfg.qk_norm, dt),
        "attn_norm": ones,
        "mlp_norm": ones.clone(),
    }
    if cfg.moe is not None:
        p["moe"] = moe.moe_params(generator, cfg, dt)
    else:
        p["mlp"] = L.swiglu_params(generator, cfg.d_model, cfg.d_ff, dt)
    return p


def _stacked_like(tree, n: int):
    """An empty tree of ``tree``'s leaves with a leading axis of ``n``."""
    if isinstance(tree, dict):
        return {k: _stacked_like(v, n) for k, v in tree.items()}
    return tree.new_empty((n, *tree.shape))


def _set_layer(stacked, tree, i: int) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _set_layer(stacked[k], v, i)
    else:
        stacked[i] = tree


def init_lm(cfg: LMConfig, generator: torch.Generator, device="cuda") -> Dict:
    """Random parameters with the JAX init's distributions (embeddings at
    std 0.02, dense layers at std 1/sqrt(fan_in), norms at 1; an MoE
    layer's as ``moe.moe_params``), drawn from ``generator`` on its own
    device and then moved to ``device``. The layers are stacked on a
    leading L axis: each stacked leaf is allocated once and filled layer by
    layer, so the draw holds the weights plus one layer's tree. On
    ``device="meta"`` the same tree of shapes and dtypes, nothing drawn."""
    dev = resolve_device(device)
    generator = init_generator(generator, dev)
    dt = _dtype(cfg)
    params = {"embed": L.embed_init(generator, cfg.vocab_padded, cfg.d_model, dt)}
    layers = None
    for i in range(cfg.n_layers):
        layer = init_layer(generator, cfg)
        if layers is None:
            layers = _stacked_like(layer, cfg.n_layers)
        _set_layer(layers, layer, i)
        del layer
    params["layers"] = layers
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dt, device=generator.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, cfg.d_model, cfg.vocab_padded, dt)
    return export.to_torch(params, dev)


def params_from_numpy(tree, device="cuda"):
    """The JAX parameter tree (nested dicts of numpy arrays, or of tensors)
    as the port's parameters: the same nesting (the layers stacked on a
    leading L axis), contiguous tensors of the same dtype on ``device``
    (bfloat16 arrays stay bfloat16)."""
    return export.to_torch(tree, device)


# ---------------------------------------------------------------------------
# full-sequence passes
# ---------------------------------------------------------------------------

def _block(cfg: LMConfig, x: torch.Tensor, lp: Dict, positions: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One transformer block over the full sequence: (x, k, v, moe_aux),
    moe_aux None for a dense layer."""
    h = L.rms_norm(x, lp["attn_norm"])
    q, k, v = L.qkv_project(lp["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                            cfg.d_head, positions, cfg.rope_theta)
    o = _attend(cfg, q, k, v)
    b, s, _, _ = o.shape
    # each product placed on the residual's layout before the add (a
    # reduce-scatter where its sum is split over "model"), so that its
    # gradient arrives gathered, as DTensor's products take it
    x = constrain(x + constrain(o.reshape(b, s, -1) @ lp["attn"]["wo"], "residual"),
                  "residual")
    y, aux = _ffn(cfg, lp, L.rms_norm(x, lp["mlp_norm"]))
    return constrain(x + constrain(y, "residual"), "residual"), k, v, aux


def _block_in(sharding, cfg: LMConfig, x: torch.Tensor, lp: Dict, positions: torch.Tensor):
    """``_block`` under ``sharding``, the sharding context the pass began
    in (``context.current()``): a rematerialised layer runs again in the
    backward, outside the caller's ``activation_sharding`` (and on another
    thread on the card), and must place and route as it did."""
    if sharding is None:
        return _block(cfg, x, lp, positions)
    with shctx.activation_sharding(sharding.mesh, sharding.rules, sharding.moe_a2a,
                                   sharding.fsdp):
        return _block(cfg, x, shctx.gather_layer(lp), positions)


def forward(params: Dict, tokens: torch.Tensor, cfg: LMConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), moe_aux): the sum of the layers'
    load-balance losses (float32; 0 for a dense model). With ``cfg.remat``
    and grad enabled each layer runs under ``checkpoint``: its activations
    are made again in the backward instead of kept."""
    x = constrain(L.embed_rows(params["embed"], tokens).to(_dtype(cfg)), "residual")
    positions = torch.arange(tokens.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    sharding = shctx.current()
    auxes = []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if remat:
            x, _, _, aux = checkpoint(_block_in, sharding, cfg, x, lp, positions,
                                      use_reentrant=False)
        else:
            x, _, _, aux = _block(cfg, x, shctx.gather_layer(lp), positions)
        if aux is not None:
            auxes.append(aux)
    x = L.rms_norm(x, params["final_norm"])
    # vocab-sharded logits: CE reduces over the sharded vocab dim in place
    logits = constrain(constrain(x, "pre_logits") @ _head(params), "logits")
    aux = (torch.sum(torch.stack(auxes)) if auxes
           else torch.zeros((), dtype=torch.float32, device=x.device))
    return _mask_padded_vocab(logits, cfg), _replicated_like(aux, x)


def _replicated_like(t: torch.Tensor, x) -> torch.Tensor:
    """``t``, a value every rank holds alike (``moe_apply_a2a``'s aux), as
    a replicated DTensor on ``x``'s mesh where ``x`` is a DTensor: summed
    into a DTensor loss as a plain tensor it would get a DTensor gradient,
    which its plain graph cannot take."""
    if not is_dtensor(x) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, x.device_mesh, [Replicate()] * x.device_mesh.ndim,
                              run_check=False)


def loss_fn(params: Dict, batch: Dict, cfg: LMConfig,
            aux_weight: float = 0.01) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy (float32, z-loss 1e-4) plus ``aux_weight``
    times the MoE auxiliary loss (0 for a dense model): ``(loss, {"ce",
    "moe_aux"})``. ``batch`` holds ``tokens`` and ``labels`` (B, S)."""
    logits, aux = forward(params, batch["tokens"], cfg)
    ce = L.cross_entropy(logits, batch["labels"], z_loss=1e-4)
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "moe_aux": aux}


def make_train_step(cfg: LMConfig, optimizer) -> Callable:
    """Returns ``f(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``loss_fn``'s value and its gradient with respect to every
    leaf of the parameter tree (``train_loop.value_and_grad``, the
    ``Trainer``'s own, which raises if a leaf is not reached: every leaf of a
    dense or MoE LM is), then the optimizer's update. The step differentiates
    detached copies of the params and returns new trees, so it mutates none
    of its inputs."""
    def step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(
            lambda p, b: loss_fn(p, b, cfg), params, batch)
        params, opt_state = optimizer.update(params, grads, opt_state)
        metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
        return params, opt_state, metrics
    return step


def prefill(params: Dict, tokens: torch.Tensor, cfg: LMConfig
            ) -> Tuple[torch.Tensor, Dict]:
    """Full pass materializing the KV cache.

    Returns (last-position logits (B, V), cache {k,v: (L, B, S, Hkv, Dh)});
    the final norm and the head run on the last position only. It runs
    under ``torch.inference_mode()`` in serving, so ``cfg.remat`` (which
    JAX's prefill also applies) changes nothing here.
    """
    x = L.embed_rows(params["embed"], tokens).to(_dtype(cfg))
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device)
    if is_dtensor(x):
        # a planned step's DTensors: the layers' K/V stacked at the end
        ks, vs = [], []
        for i in range(cfg.n_layers):
            x, k, v, _ = _block(cfg, x, _layer(params["layers"], i), positions)
            ks.append(k)
            vs.append(v)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    else:
        shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head)
        cache = {"k": torch.empty(shape, dtype=x.dtype, device=x.device),
                 "v": torch.empty(shape, dtype=x.dtype, device=x.device)}
        for i in range(cfg.n_layers):
            x, k, v, _ = _block(cfg, x, _layer(params["layers"], i), positions)
            cache["k"][i] = k
            cache["v"][i] = v
    x = L.rms_norm(L.seq_whole(x)[:, -1:, :], params["final_norm"])
    logits = _mask_padded_vocab((x @ _head(params))[:, 0, :], cfg)
    return logits, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Dict:
    """A zero cache. With ``cfg.kv_quant``: int8 ``k``, ``v`` and float32
    ``k_scale``, ``v_scale`` (L, B, max_len, Hkv), ``dtype`` ignored."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dev = resolve_device(device)
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=dev)}
    dt = dtype or _dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., dh) -> (int8 rows, per-row float32 scale). KIVI-style
    per-(token, head) absmax scaling; rounds half to even, as ``jnp.round``.
    127 is a tensor on ``x``'s device: CUDA's division by a Python scalar
    multiplies by its reciprocal, which can differ from the quotient in the
    last bit."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(-1), 1e-8) / torch.full(
        (), 127.0, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dt) -> torch.Tensor:
    """(q.float() * scale) in float32, then ``dt``: the float32 product is
    made in place on the int8 rows' float32 copy, which holds one copy of
    the layer's cache in float32 rather than two."""
    return q.float().mul_(scale[..., None]).to(dt)


def _write_rows(cache: torch.Tensor, li: int, batch_ix: torch.Tensor,
                pos: torch.Tensor, rows: torch.Tensor) -> None:
    """``cache[li, b, pos[b]] = rows[b]`` for every row b, in place. A
    DTensor cache (batch over the data axes, positions over ``model``) is
    written on each rank's block: its own batch rows, at the positions its
    block holds (the others write back what they read)."""
    if not is_dtensor(cache):
        cache[li, batch_ix, pos] = rows
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    mesh, place = cache.device_mesh, cache.placements
    local = cache.to_local()
    _, offset = compute_local_shape_and_global_offset(cache.shape, mesh, place)
    batch = tuple(Shard(0) if isinstance(pl, Shard) and pl.dim == 1 else Replicate()
                  for pl in place)
    rows = rows.redistribute(mesh, batch).to_local() if is_dtensor(rows) else rows
    pos = pos.redistribute(mesh, batch).to_local() if is_dtensor(pos) else pos
    n_pos = local.shape[2]
    rel = pos - offset[2]
    mine = (rel >= 0) & (rel < n_pos)
    rel = rel.clamp(0, n_pos - 1)
    bi = torch.arange(local.shape[1], device=local.device)
    here = local[li, bi, rel]
    mine = mine.reshape(mine.shape + (1,) * (here.dim() - 1))
    local[li, bi, rel] = torch.where(mine, rows.to(local.dtype), here)


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: LMConfig) -> Tuple[torch.Tensor, Dict]:
    """One decode step.

    tokens: (B,) new token ids; pos: (B,) their positions.
    cache: ``init_cache``'s {k,v: (L, B, S, Hkv, Dh)}, with k_scale,
    v_scale under ``cfg.kv_quant``. Returns (logits (B, V), cache).

    Unlike the JAX function, which returns a new cache, this one writes each
    layer's new K/V rows (quantized, and their scales, under
    ``cfg.kv_quant``) into ``cache`` IN PLACE and returns the same dict:
    the caller's cache is changed, and a cache from before the step is not
    kept. Row b attends to its positions ``< pos[b] + 1``.
    """
    b = tokens.shape[0]
    dt = _dtype(cfg)
    x = L.embed_rows(params["embed"], tokens)[:, None, :].to(dt)   # (B,1,d)
    pos = pos.long()
    batch_ix = torch.arange(b, device=x.device)
    for li in range(cfg.n_layers):
        lp = _layer(params["layers"], li)
        h = L.rms_norm(x, lp["attn_norm"])
        q, k, v = L.qkv_project(lp["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                                cfg.d_head, pos[:, None], cfg.rope_theta)
        if cfg.kv_quant:
            for key, new in (("k", k), ("v", v)):
                rows, scale = _kv_quantize(new[:, 0])
                _write_rows(cache[key], li, batch_ix, pos, rows)
                _write_rows(cache[f"{key}_scale"], li, batch_ix, pos, scale)
            k_read = _kv_dequantize(cache["k"][li], cache["k_scale"][li], dt)
            v_read = _kv_dequantize(cache["v"][li], cache["v_scale"][li], dt)
        else:
            _write_rows(cache["k"], li, batch_ix, pos, k[:, 0])
            _write_rows(cache["v"], li, batch_ix, pos, v[:, 0])
            k_read, v_read = cache["k"][li], cache["v"][li]
        o = L.decode_attention(q, k_read, v_read, kv_len=pos + 1)
        x = x + o.reshape(b, 1, -1) @ lp["attn"]["wo"]
        h = L.rms_norm(x, lp["mlp_norm"])
        # the gather formulation under any sharding context, as JAX's
        # decode_step: a one-token sequence does not shard over "model"
        x = x + (moe.moe_apply(lp["moe"], h, cfg)[0] if cfg.moe is not None
                 else L.swiglu_apply(lp["mlp"], h))
    x = L.rms_norm(x, params["final_norm"])
    logits = _mask_padded_vocab((x @ _head(params))[:, 0, :], cfg)
    return logits, cache
