"""Synthetic recsys logs: per-field-vocab-valid ids, hidden-model labels.

A numpy copy of the JAX package's ``data/recsys.py``: the same seed gives
the same arrays, byte for byte, in both packages.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import RecsysConfig


def _ids(rng, batch: int, vocab_sizes) -> np.ndarray:
    v = np.asarray(vocab_sizes, np.int64)
    u = rng.integers(0, 1 << 62, size=(batch, len(v)))
    return (u % v[None, :]).astype(np.int32)


def batch_for(cfg: RecsysConfig, batch: int, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    if cfg.kind == "fm":
        ids = _ids(rng, batch, cfg.vocab_sizes)
        label = (ids.sum(1) % 2).astype(np.float32)  # learnable parity-ish
        return {"ids": ids, "label": label}
    if cfg.kind == "dlrm":
        ids = _ids(rng, batch, cfg.vocab_sizes)
        dense = rng.lognormal(0.0, 1.0, (batch, cfg.n_dense)).astype(np.float32)
        label = ((dense.sum(1) + ids.sum(1)) % 2 > 0.5).astype(np.float32)
        return {"dense": dense, "ids": ids, "label": label}
    if cfg.kind == "din":
        hist = rng.integers(0, cfg.n_items, (batch, cfg.seq_len)).astype(np.int32)
        lens = rng.integers(1, cfg.seq_len + 1, batch)
        mask = (np.arange(cfg.seq_len)[None, :] < lens[:, None]).astype(np.float32)
        target = rng.integers(0, cfg.n_items, batch).astype(np.int32)
        label = (target % 2).astype(np.float32)
        return {"hist": hist, "hist_mask": mask, "target": target, "label": label}
    if cfg.kind == "bert4rec":
        seq = rng.integers(0, cfg.n_items, (batch, cfg.seq_len)).astype(np.int32)
        label = rng.integers(0, cfg.n_items, batch).astype(np.int32)
        neg = rng.integers(0, cfg.n_items, (batch, cfg.n_negatives)).astype(np.int32)
        return {"seq": seq, "label": label, "negatives": neg}
    raise ValueError(cfg.kind)


def batches(cfg: RecsysConfig, batch: int, seed: int = 0
            ) -> Iterator[Dict[str, np.ndarray]]:
    i = 0
    while True:
        yield batch_for(cfg, batch, seed + i)
        i += 1


def retrieval_batch(cfg: RecsysConfig, n_candidates: int, seed: int = 0
                    ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    if cfg.kind == "fm":
        return {"user_ids": _ids(rng, 1, cfg.vocab_sizes[:-1]),
                "candidates": (rng.integers(0, 1 << 62, n_candidates)
                               % cfg.vocab_sizes[-1]).astype(np.int32)}
    if cfg.kind == "dlrm":
        return {"dense": rng.lognormal(0, 1, (1, cfg.n_dense)).astype(np.float32),
                "user_ids": _ids(rng, 1, cfg.vocab_sizes[:-1]),
                "candidates": (rng.integers(0, 1 << 62, n_candidates)
                               % cfg.vocab_sizes[-1]).astype(np.int32)}
    if cfg.kind == "din":
        return {"hist": rng.integers(0, cfg.n_items, (1, cfg.seq_len)).astype(np.int32),
                "hist_mask": np.ones((1, cfg.seq_len), np.float32),
                "candidates": rng.integers(0, cfg.n_items, n_candidates).astype(np.int32)}
    return {"seq": rng.integers(0, cfg.n_items, (1, cfg.seq_len)).astype(np.int32),
            "candidates": rng.integers(0, cfg.n_items, n_candidates).astype(np.int32)}
