"""Decoder-only LM: dense, GQA + RoPE (+qk_norm), a loop over stacked layers.

The port of the JAX package's ``models/transformer.py``, with its names,
parameter tree and layouts:

  forward      tokens (B, S) -> (logits (B, S, V), moe_aux)
  loss_fn      (loss, {"ce", "moe_aux"}): next-token cross-entropy with
               z-loss 1e-4 (training)
  make_train_step  f(params, opt_state, batch) -> (params, opt_state, metrics)
  prefill      full pass that also materializes the KV cache:
               (last-position logits (B, V), {k, v: (L, B, S, Hkv, Dh)})
  init_cache   a zero cache {k, v: (L, B, max_len, Hkv, Dh)}
  decode_step  one new token per row against the cache

Layer parameters are stacked on a leading L axis, as in JAX; ``lax.scan``
becomes a Python loop over the layer index that takes views of the stacked
tensors, never copies. With ``attn_impl="flash"`` every full-sequence layer
runs its attention on the CUDA kernel of ``kernels/flash_attention.py`` (the
plain version on CPU tensors); ``"chunked"`` runs ``layers.causal_attention``
in plain torch. Decode attention is plain torch, as the JAX package leaves
it to XLA.

Training differentiates ``forward`` with autograd. Under ``"flash"`` the
attention's gradient is the attention module's own backward
(``FlashAttention``: the CUDA backward kernel on the card, the plain
backward on the CPU), the port of ``flash_attention_jnp``'s custom VJP, so
every parameter gets its gradient and no (S, S) scores are kept. The
layers are not rematerialised (``cfg.remat`` is the JAX package's
``jax.checkpoint``; here every layer's activations are kept), so a training
step runs the attention forward once a layer and its backward once.

Not ported yet, and refused with ``NotImplementedError``: MoE layers
(``cfg.moe``, ROADMAP.md §1 item 10b) and the int8 KV cache
(``cfg.kv_quant``, ROADMAP.md §1 item 10a). Nothing here disables autograd:
serving callers run under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import LMConfig
from repro_torch.core import export
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.training.train_loop import value_and_grad


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_supported(cfg: LMConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers (models/moe.py) are not ported yet "
            f"(ROADMAP.md §1 item 10b)")
    if cfg.kv_quant:
        raise NotImplementedError(
            f"{cfg.name}: the int8 KV cache (kv_quant) is not ported yet "
            f"(ROADMAP.md §1 item 10a)")


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


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_layer(generator: torch.Generator, cfg: LMConfig) -> Dict:
    _check_supported(cfg)
    dt = _dtype(cfg)
    ones = torch.ones((cfg.d_model,), dtype=dt, device=generator.device)
    return {
        "attn": L.attn_params(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.d_head, cfg.qk_norm, dt),
        "attn_norm": ones,
        "mlp_norm": ones.clone(),
        "mlp": L.swiglu_params(generator, cfg.d_model, cfg.d_ff, dt),
    }


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_lm(cfg: LMConfig, generator: torch.Generator, device="cuda") -> Dict:
    """Random parameters with the JAX init's distributions (embeddings at
    std 0.02, dense layers at std 1/sqrt(fan_in), norms at 1), drawn from
    ``generator`` on its own device and then moved to ``device``. The layers
    are stacked on a leading L axis."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    params = {
        "embed": L.embed_init(generator, cfg.vocab_padded, cfg.d_model, dt),
        "layers": _stack([init_layer(generator, cfg) for _ in range(cfg.n_layers)]),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=generator.device),
    }
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
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One transformer block over the full sequence: (x, k, v)."""
    h = L.rms_norm(x, lp["attn_norm"])
    q, k, v = L.qkv_project(lp["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                            cfg.d_head, positions, cfg.rope_theta)
    o = _attend(cfg, q, k, v)
    b, s, _, _ = o.shape
    x = x + o.reshape(b, s, -1) @ lp["attn"]["wo"]
    x = x + L.swiglu_apply(lp["mlp"], L.rms_norm(x, lp["mlp_norm"]))
    return x, k, v


def forward(params: Dict, tokens: torch.Tensor, cfg: LMConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), moe_aux); moe_aux is 0 (dense)."""
    _check_supported(cfg)
    x = params["embed"][tokens.long()].to(_dtype(cfg))
    positions = torch.arange(tokens.shape[1], device=x.device)
    for i in range(cfg.n_layers):
        x, _, _ = _block(cfg, x, _layer(params["layers"], i), positions)
    x = L.rms_norm(x, params["final_norm"])
    logits = x @ _head(params)
    return (_mask_padded_vocab(logits, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


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
    dense LM is), then the optimizer's update. The step differentiates
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
    the final norm and the head run on the last position only.
    """
    _check_supported(cfg)
    x = params["embed"][tokens.long()].to(_dtype(cfg))
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device)
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head)
    cache = {"k": torch.empty(shape, dtype=x.dtype, device=x.device),
             "v": torch.empty(shape, dtype=x.dtype, device=x.device)}
    for i in range(cfg.n_layers):
        x, k, v = _block(cfg, x, _layer(params["layers"], i), positions)
        cache["k"][i] = k
        cache["v"][i] = v
    x = L.rms_norm(x[:, -1:, :], params["final_norm"])
    logits = _mask_padded_vocab((x @ _head(params))[:, 0, :], cfg)
    return logits, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Dict:
    _check_supported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dt = dtype or _dtype(cfg)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: LMConfig) -> Tuple[torch.Tensor, Dict]:
    """One decode step.

    tokens: (B,) new token ids; pos: (B,) their positions.
    cache: {k,v: (L, B, S, Hkv, Dh)}. Returns (logits (B, V), cache).

    Unlike the JAX function, which returns a new cache, this one writes each
    layer's new K/V rows into ``cache`` IN PLACE and returns the same dict:
    the caller's cache is changed, and a cache from before the step is not
    kept. Row b attends to its positions ``< pos[b] + 1``.
    """
    _check_supported(cfg)
    b = tokens.shape[0]
    x = params["embed"][tokens.long()][:, None, :].to(_dtype(cfg))   # (B,1,d)
    pos = pos.long()
    batch_ix = torch.arange(b, device=x.device)
    for li in range(cfg.n_layers):
        lp = _layer(params["layers"], li)
        h = L.rms_norm(x, lp["attn_norm"])
        q, k, v = L.qkv_project(lp["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                                cfg.d_head, pos[:, None], cfg.rope_theta)
        cache["k"][li, batch_ix, pos] = k[:, 0]
        cache["v"][li, batch_ix, pos] = v[:, 0]
        o = L.decode_attention(q, cache["k"][li], cache["v"][li], kv_len=pos + 1)
        x = x + o.reshape(b, 1, -1) @ lp["attn"]["wo"]
        x = x + L.swiglu_apply(lp["mlp"], L.rms_norm(x, lp["mlp_norm"]))
    x = L.rms_norm(x, params["final_norm"])
    logits = _mask_padded_vocab((x @ _head(params))[:, 0, :], cfg)
    return logits, cache
