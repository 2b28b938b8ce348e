"""Synthetic LM token pipeline: zipfian unigram stream + sequence packing.

A numpy copy of the JAX package's ``data/lm.py``: the same seed gives the
same tokens in both packages.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def token_batches(vocab_size: int, batch: int, seq_len: int, seed: int = 0,
                  zipf_a: float = 1.2) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite stream of {tokens, labels} with next-token labels."""
    rng = np.random.default_rng(seed)
    while True:
        # zipf over [1, vocab); clip tail into vocab
        toks = rng.zipf(zipf_a, size=(batch, seq_len + 1))
        toks = (toks - 1) % vocab_size
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
