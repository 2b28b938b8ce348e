"""PyTorch + CUDA port of the multi-stage neural reranking system.

The package mirrors the layout of ``repro`` (``configs/``, ``data/``,
``core/``, ``models/``, ``kernels/``, ``serving/``) module for module, and
keeps its public layouts: filters in the im2col layout ``(w*d, F)``, token
rows ``(B, max_len)`` int, overlap features ``(B, 4)`` float32, and the
``RPROAVRO1`` weight format. It imports ``torch`` and numpy only.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise instead of falling back. The
init functions also take ``device="meta"``: shapes and dtypes only, nothing
allocated and nothing drawn (the twin of ``jax.eval_shape`` of an init),
which the dry-run planner builds its cells from.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "init_generator", "randn"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """The ``torch.device`` an entry point runs on. ``None`` means the
    default (``"cuda"``). A CUDA device without a card raises: the port
    never falls back to the CPU unless asked to. ``"meta"`` means shapes
    only; it never stands in for a missing card."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA card is available; "
            f"pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda, cpu or meta)")
    return dev


class _ShapeOnly(torch.Generator):
    """A generator whose ``device`` reads ``meta``: init code that draws
    "on the generator's device" then makes meta tensors, which hold no
    values, so nothing is drawn and the generator's state never moves."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def init_generator(generator: torch.Generator, device) -> torch.Generator:
    """The generator an init function draws from for ``device``: the
    caller's, or on ``meta`` a shape-only one (the caller's is left
    untouched)."""
    return _ShapeOnly() if resolve_device(device).type == "meta" else generator


def randn(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal float32 values of ``shape`` drawn from ``generator``
    on its device; from a shape-only generator, a meta tensor (a meta
    ``torch.randn`` handed a generator is slow)."""
    if isinstance(generator, _ShapeOnly):
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=generator, device=generator.device)
