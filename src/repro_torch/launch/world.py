"""The canonical demo world: corpus + BM25 index + trained sm-cnn.

The weights are drawn by ``init_sm_cnn`` from ``torch.Generator().
manual_seed(seed)``, where the JAX package draws them from
``jax.random.PRNGKey(seed)``: the two launchers' worlds share corpus,
tokenizer, index and training stream, but not their weights. Tests that
compare the packages give both the same initial tree
(``sm_cnn.init_sm_cnn_numpy``) instead.
"""
from __future__ import annotations

import functools
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import bm25 as BM
from repro_torch.data import qa as QA
from repro_torch.data.tokenizer import HashingTokenizer
from repro_torch.models import sm_cnn
from repro_torch.training.optimizer import adamw
from repro_torch.training.train_loop import Trainer


def build_world(train_steps: int = 60, seed: int = 0, device="cuda"):
    """Returns (cfg, params, corpus, tokenizer, index, eval_pairs); the
    params are tensors on ``device``, trained there for ``train_steps``
    steps of batch 64."""
    cfg = reduced(get_config("sm-cnn"))
    corpus = QA.generate_corpus(n_docs=80, n_questions=60, seed=seed)
    tok = HashingTokenizer(cfg.vocab_size)
    index = BM.build_index([tok.encode(" ".join(d)) for d in corpus.documents],
                           cfg.vocab_size)
    params = sm_cnn.init_sm_cnn(cfg, torch.Generator().manual_seed(seed),
                                device)
    tr = Trainer(functools.partial(sm_cnn.loss_fn, cfg=cfg), adamw(3e-3), params)

    def stream():
        ep = 0
        while True:
            yield from QA.pair_batches(corpus, tok, cfg.max_len, 64, seed=ep)
            ep += 1

    tr.run(stream(), max_steps=train_steps, log_every=0)
    eval_pairs = [p for i, p in enumerate(corpus.pairs) if i % 10 == 0]
    return cfg, tr.params, corpus, tok, index, eval_pairs


def eval_batches(corpus, tok, cfg, pairs, batch: int
                 ) -> List[Dict[str, np.ndarray]]:
    out = []
    for i in range(0, len(pairs) - batch + 1, batch):
        out.append(QA.make_batch(corpus, tok, cfg.max_len,
                                 pairs[i:i + batch]))
    return out


def percentile_stats(latencies_s: List[float]) -> Tuple[float, float]:
    arr = np.sort(np.asarray(latencies_s))
    p50 = float(arr[int(0.50 * (len(arr) - 1))])
    p99 = float(arr[int(0.99 * (len(arr) - 1))])
    return p50, p99


def timed(fn, *args) -> float:
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0
