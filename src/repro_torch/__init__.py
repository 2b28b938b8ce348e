"""PyTorch + CUDA port of the multi-stage neural reranking system.

The package mirrors the layout of ``repro`` (``configs/``, ``data/``,
``core/``, ``models/``, ``kernels/``, ``serving/``) module for module, and
keeps its public layouts: filters in the im2col layout ``(w*d, F)``, token
rows ``(B, max_len)`` int, overlap features ``(B, 4)`` float32, and the
``RPROAVRO1`` weight format. It imports ``torch`` and numpy only.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """The ``torch.device`` an entry point runs on. ``None`` means the
    default (``"cuda"``). A CUDA device without a card raises: the port
    never falls back to the CPU unless asked to."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA card is available; "
            f"pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
