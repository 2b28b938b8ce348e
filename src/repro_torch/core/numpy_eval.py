"""Pure-NumPy feedforward evaluation of the exported sm-cnn.

The paper's Deeplearning4J condition: take the weights OUT of the training
framework and re-implement feedforward in a different in-process runtime.
The evaluation is numpy alone: no torch op touches the scores. The blob is
read through the port's ``core/export`` (which imports torch; its
``loads`` is numpy alone), so a ``RPROAVRO1`` blob written by either package gives the
same scores. It is the "language-uniform, monolithic" integration, compared
with the compiled backends in ``chip_smoke.py``'s ``backends`` phase.

Both the im2col-GEMM formulation and the paper's naive loop-over-filters
formulation are provided (the paper found 100x between them in ND4J).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core import export as export_lib


class NumpySMCNN:
    """Feedforward-only evaluator over exported weights."""

    def __init__(self, tensors: Dict[str, np.ndarray], filter_width: int):
        t = {k: v.astype(np.float32) for k, v in tensors.items()}
        self.embed = t["embed"]
        self.conv_q = (t["conv_q/w"], t["conv_q/b"])
        self.conv_a = (t["conv_a/w"], t["conv_a/b"])
        self.join = (t["join/w"], t["join/b"])
        self.out = (t["out/w"], t["out/b"])
        self.width = filter_width

    @classmethod
    def from_bytes(cls, data: bytes) -> "NumpySMCNN":
        tensors, header = export_lib.loads(data)
        return cls(tensors, int(header["meta"]["filter_width"]))

    @classmethod
    def from_file(cls, path: str) -> "NumpySMCNN":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    # -- ops ---------------------------------------------------------------

    def _im2col(self, x: np.ndarray) -> np.ndarray:
        b, s, d = x.shape
        pad = self.width - 1
        xp = np.zeros((b, s + 2 * pad, d), np.float32)
        xp[:, pad:pad + s] = x
        n_win = s + self.width - 1
        cols = [xp[:, i:i + n_win, :] for i in range(self.width)]
        return np.concatenate(cols, axis=-1)

    def _arm(self, conv, x_emb: np.ndarray) -> np.ndarray:
        w, b = conv
        h = np.tanh(self._im2col(x_emb) @ w + b)
        return h.max(axis=1)

    def _arm_naive(self, conv, x_emb: np.ndarray) -> np.ndarray:
        """Loop over filters + positions — the paper's naive ND4J condition."""
        w, b = conv
        bsz, s, d = x_emb.shape
        f = w.shape[1]
        w3 = w.reshape(self.width, d, f)
        pad = self.width - 1
        xp = np.zeros((bsz, s + 2 * pad, d), np.float32)
        xp[:, pad:pad + s] = x_emb
        n_win = s + self.width - 1
        out = np.empty((bsz, f), np.float32)
        for fi in range(f):
            filt = w3[:, :, fi]
            best = np.full((bsz,), -np.inf, np.float32)
            for i in range(n_win):
                v = np.tanh((xp[:, i:i + self.width, :] * filt).sum((1, 2)) + b[fi])
                best = np.maximum(best, v)
            out[:, fi] = best
        return out

    # -- public API (mirrors the Thrift IDL) --------------------------------

    def log_probs(self, q_tok: np.ndarray, a_tok: np.ndarray,
                  feats: np.ndarray, naive: bool = False) -> np.ndarray:
        arm = self._arm_naive if naive else self._arm
        xq = arm(self.conv_q, self.embed[q_tok])
        xa = arm(self.conv_a, self.embed[a_tok])
        xj = np.concatenate([xq, xa, feats.astype(np.float32)], axis=-1)
        h = np.tanh(xj @ self.join[0] + self.join[1])
        logits = h @ self.out[0] + self.out[1]
        m = logits.max(axis=-1, keepdims=True)
        lse = m + np.log(np.exp(logits - m).sum(-1, keepdims=True))
        return logits - lse

    def get_score(self, q_tok: np.ndarray, a_tok: np.ndarray,
                  feats: np.ndarray, naive: bool = False) -> np.ndarray:
        """P(relevant) per pair — the paper's getScore."""
        return np.exp(self.log_probs(q_tok, a_tok, feats, naive))[:, 1]
