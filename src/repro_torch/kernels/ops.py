"""Public wrappers of the kernels and model-level compositions over them.

``flash_attention`` is the causal GQA attention kernel's wrapper (the
Pallas kernel's block sizes are the CUDA kernel's own business here, so it
takes no ``block_q``/``block_kv``).

``sm_cnn_score`` is the full paper model with both conv arms running through
the fused conv kernel — the ``pallas`` integration backend (the name is kept
from the JAX package, where the kernel is written in Pallas; here it is the
hand-written CUDA kernel). The join and output layers are plain products.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import TextPairConfig
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.sm_cnn_conv import conv_tanh_maxpool


def sm_cnn_score(params: Dict, q_tok: torch.Tensor, a_tok: torch.Tensor,
                 feats: torch.Tensor, cfg: TextPairConfig) -> torch.Tensor:
    """P(relevant) with both conv arms on the fused conv kernel."""
    emb = params["embed"]
    w = cfg.filter_width
    xq = conv_tanh_maxpool(emb[q_tok.long()], params["conv_q"]["w"],
                           params["conv_q"]["b"], w)
    xa = conv_tanh_maxpool(emb[a_tok.long()], params["conv_a"]["w"],
                           params["conv_a"]["b"], w)
    xj = torch.cat([xq, xa, feats.to(xq.dtype)], dim=-1)
    h = torch.tanh(xj @ params["join"]["w"] + params["join"]["b"])
    logits = h @ params["out"]["w"] + params["out"]["b"]
    return torch.softmax(logits, dim=-1)[:, 1]
