"""Integration backends — the paper's strategies as ``Scorer``s.

  eager  : the model's plain PyTorch ops, one dispatch at a time
  pallas : both conv arms on the hand-written CUDA conv kernel
           (``kernels/ops.sm_cnn_score``; the name is the JAX package's)

``jit``, ``aot``, ``numpy`` and ``artifact`` keep their names and raise
``NotImplementedError`` until their slice of the port lands.

All backends expose ``score(q_tok, a_tok, feats) -> np.ndarray`` over numpy
inputs: token rows ``(B, max_len)`` int, features ``(B, 4)`` float32. The
rows go to the scorer's device, the scores come back to the host.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import TextPairConfig
from repro_torch.models import sm_cnn
from repro_torch.serving import telemetry

BACKENDS = ("eager", "jit", "aot", "numpy", "pallas", "artifact")
PORTED_BACKENDS = ("eager", "pallas")


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class Scorer:
    """Uniform scoring interface over any integration backend.

    ``calls`` counts the batches handed to the backend (after padding to a
    bucket and chunking past the top bucket)."""

    def __init__(self, fn: Callable, buckets: Sequence[int], name: str):
        self._fn = fn
        self._buckets = tuple(buckets)
        self.name = name
        self.calls = 0

    def __call__(self, q_tok, a_tok, feats) -> np.ndarray:
        n = q_tok.shape[0]
        cap = self._buckets[-1]
        if n > cap:  # coalesced cross-query batches: chunk to the top bucket
            return np.concatenate(
                [self(q_tok[i:i + cap], a_tok[i:i + cap], feats[i:i + cap])
                 for i in range(0, n, cap)])
        b = _bucket(n, self._buckets)
        if b != n:  # pad to the bucket: a fixed set of shapes reaches the card
            pad = b - n
            q_tok = np.concatenate([q_tok, np.zeros((pad,) + q_tok.shape[1:], q_tok.dtype)])
            a_tok = np.concatenate([a_tok, np.zeros((pad,) + a_tok.shape[1:], a_tok.dtype)])
            feats = np.concatenate([feats, np.zeros((pad,) + feats.shape[1:], feats.dtype)])
        tracer = telemetry.get_tracer()
        self.calls += 1
        # Only open a kernel-side span when this call is already inside a
        # request trace; untraced benchmark loops should not flood the ring
        # with roots. The copy of the scores to the host waits for the card,
        # so the time covers the device work.
        if tracer.current_context() is not None:
            with tracer.span("scorer", backend=self.name, rows=n, bucket=b):
                t0 = time.perf_counter()
                out = self._fn(q_tok, a_tok, feats)
                dt_ms = (time.perf_counter() - t0) * 1e3
        else:
            t0 = time.perf_counter()
            out = self._fn(q_tok, a_tok, feats)
            dt_ms = (time.perf_counter() - t0) * 1e3
        telemetry.get_registry().observe("scorer_batch_ms", dt_ms,
                                         backend=self.name, bucket=b)
        return out[:n]


def _on_device(model_fn: Callable, params: Dict, cfg: TextPairConfig,
               dev: torch.device) -> Callable:
    """numpy rows in, numpy scores out; the model runs on ``dev``."""
    def fn(q, a, f) -> np.ndarray:
        with torch.inference_mode():
            s = model_fn(params,
                         torch.from_numpy(np.ascontiguousarray(q)).to(dev),
                         torch.from_numpy(np.ascontiguousarray(a)).to(dev),
                         torch.from_numpy(np.ascontiguousarray(f, np.float32)).to(dev),
                         cfg)
            return s.float().cpu().numpy()
    return fn


def make_scorer(backend: str, params: Dict, cfg: TextPairConfig,
                buckets: Sequence[int] = (1, 8, 64, 256),
                device="cuda") -> Scorer:
    """A ``Scorer`` for ``backend`` over ``params`` (the JAX parameter tree
    as numpy arrays, or the port's tensors), running on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if backend not in PORTED_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (ported: "
            f"{PORTED_BACKENDS}); it arrives with the backends slice of the "
            f"port, after the main path (see ROADMAP.md)")
    dev = resolve_device(device)
    p = sm_cnn.params_from_numpy(params, dev)
    if backend == "eager":
        return Scorer(_on_device(sm_cnn.score, p, cfg, dev), buckets, backend)
    from repro_torch.kernels import ops as kops
    return Scorer(_on_device(kops.sm_cnn_score, p, cfg, dev), buckets, backend)
