"""The paper's answer-selection CNN (Severyn & Moschitti 2015, simplified per
Rao et al. 2017: no bilinear similarity term), over a parameter dict.

Siamese structure: each arm embeds a token sequence, applies a WIDE 1-D
convolution (padding = filter_width-1 on both sides, per the paper's
``padding=filter_width-1``), tanh, then global max-pool to a (F,) vector.
The join layer concatenates [x_q; x_a; x_feat(4 overlap features)], applies
a tanh hidden layer and a 2-way softmax; ``score = P(relevant)``.

Parameters are the JAX package's tree with tensors for arrays:
``{"embed": (V, d), "conv_q": {"w": (w*d, F), "b": (F,)}, "conv_a": ...,
"join": {"w", "b"}, "out": {"w", "b"}}``, filters in the im2col layout.
Sequences are fixed-length ``max_len``; PAD id 0 gathers ``embed[0]`` like
any other id (the embedding init does not zero that row), and the max-pool
runs over all ``max_len + width - 1`` windows.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import TextPairConfig


def _dtype(cfg: TextPairConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_sm_cnn(cfg: TextPairConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    """Random parameters with the JAX init's distributions (normal embeddings
    at std 0.02, dense layers at std 1/sqrt(fan_in), zero biases), drawn
    from ``generator`` on the CPU and then moved to ``device``."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    w, d, f = cfg.filter_width, cfg.embed_dim, cfg.conv_filters

    def normal(shape, std):
        return (torch.randn(shape, generator=generator) * std).to(dt)

    def dense(d_in, d_out):
        return {"w": normal((d_in, d_out), 1.0 / math.sqrt(d_in)),
                "b": torch.zeros((d_out,), dtype=dt)}

    j_in = 2 * f + cfg.n_extra_feats
    tree = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "conv_q": dense(w * d, f),
        "conv_a": dense(w * d, f),
        "join": dense(j_in, cfg.n_hidden),
        "out": dense(cfg.n_hidden, 2),
    }
    return params_from_numpy(tree, dev)


def init_sm_cnn_numpy(cfg: TextPairConfig, seed: int = 0) -> Dict:
    """The same distributions drawn with numpy from ``seed``: a tree of
    float32 arrays that both packages can load (``params_from_numpy`` here,
    ``jnp.asarray`` on the JAX side)."""
    rng = np.random.default_rng(seed)
    w, d, f = cfg.filter_width, cfg.embed_dim, cfg.conv_filters

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def dense(d_in, d_out):
        return {"w": normal((d_in, d_out), 1.0 / math.sqrt(d_in)),
                "b": np.zeros((d_out,), np.float32)}

    j_in = 2 * f + cfg.n_extra_feats
    return {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "conv_q": dense(w * d, f),
        "conv_a": dense(w * d, f),
        "join": dense(j_in, cfg.n_hidden),
        "out": dense(cfg.n_hidden, 2),
    }


def params_from_numpy(tree, device="cuda"):
    """The JAX parameter tree (nested dicts of numpy arrays, or of tensors)
    as the port's parameters: the same nesting, contiguous tensors of the
    same dtype on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(tree)))
    return t.to(dev).contiguous()


def im2col(x: torch.Tensor, width: int) -> torch.Tensor:
    """(B, S, d) -> (B, S + width - 1, width*d) wide-conv window matrix."""
    s = x.shape[1]
    pad = width - 1
    xp = F.pad(x, (0, 0, pad, pad))
    n_win = s + width - 1
    return torch.cat([xp[:, i:i + n_win, :] for i in range(width)], dim=-1)


def conv_arm(conv: Dict, x_emb: torch.Tensor, width: int) -> torch.Tensor:
    """Wide conv1d + tanh + global max-pool: (B, S, d) -> (B, F)."""
    cols = im2col(x_emb, width)                   # (B, S+w-1, w*d)
    h = torch.tanh(cols @ conv["w"] + conv["b"])  # (B, S+w-1, F)
    return h.amax(dim=1)


def forward(params: Dict, q_tok: torch.Tensor, a_tok: torch.Tensor,
            feats: torch.Tensor, cfg: TextPairConfig) -> torch.Tensor:
    """Returns log-probs (B, 2)."""
    emb = params["embed"]
    xq = conv_arm(params["conv_q"], emb[q_tok.long()], cfg.filter_width)
    xa = conv_arm(params["conv_a"], emb[a_tok.long()], cfg.filter_width)
    xj = torch.cat([xq, xa, feats.to(xq.dtype)], dim=-1)
    h = torch.tanh(xj @ params["join"]["w"] + params["join"]["b"])
    logits = h @ params["out"]["w"] + params["out"]["b"]
    return torch.log_softmax(logits, dim=-1)


def score(params: Dict, q_tok, a_tok, feats, cfg: TextPairConfig) -> torch.Tensor:
    """P(relevant) — the paper's ``getScore`` (exp of log-softmax column 1)."""
    return torch.exp(forward(params, q_tok, a_tok, feats, cfg))[:, 1]
