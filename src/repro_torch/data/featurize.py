"""Cached (query, answer) featurization shared by serving and batch ranking.

The sequential ``RerankStage`` re-tokenizes the query once PER CANDIDATE and
the serving engine re-featurizes every (question, answer) pair on every
request. Both are pure functions of their string inputs, so this module
memoizes them: query/answer token rows by text, overlap features by pair.
Bounded LRU (``OrderedDict`` recency order) keeps steady-state serving memory
flat under heavy repeated traffic.
"""
from __future__ import annotations

from collections import OrderedDict
# Lock by name, not threading.Lock(): the runtime lock sanitizer's static
# identity map (analysis/sanitizer.py) is of the JAX package's locks only.
from threading import Lock
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.data.tokenizer import STOPWORDS, HashingTokenizer


class LRUCache:
    """Minimal LRU map; hits/misses counters for serving stats. Thread-safe:
    ServingEngine serves concurrent clients through one shared cache."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: "OrderedDict" = OrderedDict()
        self._lock = Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
            self.misses += 1
            return None

    def put(self, key, value):
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


class FeaturizationCache:
    """Memoized tokenization + overlap features over a fixed tokenizer/idf.

    ``query_row``/``answer_row`` return the padded int32 token row for a text
    (encoded once, reused across every candidate / request); ``pair_feats``
    returns the 4 overlap features for a (query, answer) pair.
    """

    def __init__(self, tokenizer: HashingTokenizer, idf: Dict[str, float],
                 max_len: int, capacity: int = 8192):
        self.tok = tokenizer
        self.idf = idf
        self.max_len = max_len
        self._tok_cache = LRUCache(capacity)
        self._pair_cache = LRUCache(capacity)
        self._words_cache = LRUCache(capacity)

    def _row(self, text: str) -> np.ndarray:
        row = self._tok_cache.get(text)
        if row is None:
            row = np.asarray(self.tok.encode(text, self.max_len), np.int32)
            self._tok_cache.put(text, row)
        return row

    query_row = _row
    answer_row = _row

    def _word_state(self, text: str):
        """Per-text overlap state, computed once: for each stopword filter,
        (word set, idf denominator) — the query-side terms of
        ``overlap_features`` that don't depend on the answer."""
        state = self._words_cache.get(text)
        if state is None:
            words = self.tok.words(text)
            state = []
            for filt in (False, True):
                ws = {w for w in words
                      if not (filt and w in STOPWORDS)}
                denom_idf = sum(self.idf.get(w, 0.0) for w in ws) or 1.0
                state.append((ws, denom_idf))
            self._words_cache.put(text, state)
        return state

    def pair_feats(self, query: str, answer: str) -> np.ndarray:
        key = (query, answer)
        feats = self._pair_cache.get(key)
        if feats is None:
            q_state, a_state = self._word_state(query), self._word_state(answer)
            feats = np.zeros((4,), np.float32)
            for j, ((qs, denom_idf), (as_, _)) in enumerate(
                    zip(q_state, a_state)):
                inter = qs & as_
                feats[2 * j] = len(inter) / max(len(qs), 1)
                feats[2 * j + 1] = (sum(self.idf.get(w, 0.0) for w in inter)
                                    / denom_idf)
            self._pair_cache.put(key, feats)
        return feats

    def featurize(self, query: str, answer: str
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (self._row(query), self._row(answer),
                self.pair_feats(query, answer))

    def pair_feats_many(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        """Overlap features for a cross-query pair list: cached pairs come
        from the LRU, the misses go through one vectorized word-incidence
        matmul per stopword filter instead of a Python loop per pair."""
        if not pairs:
            return np.zeros((0, 4), np.float32)
        out = np.empty((len(pairs), 4), np.float32)
        miss = []
        for i, (q, a) in enumerate(pairs):
            feats = self._pair_cache.get((q, a))
            if feats is None:
                miss.append(i)
            else:
                out[i] = feats
        if miss:
            fresh = self._pair_feats_matrix([pairs[i] for i in miss])
            for row, i in enumerate(miss):
                out[i] = fresh[row]
                self._pair_cache.put(tuple(pairs[i]), fresh[row])
        return out

    def _pair_feats_matrix(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        """Vectorized restatement of ``tokenizer.overlap_features`` (the
        canonical formula — keep the three in sync; ``_word_state``/
        ``pair_feats`` are its cached scalar form). float64 accumulation
        matches the scalar path to within float32 rounding (summation order
        differs, so the last ulp before the cast is not guaranteed)."""
        q_texts = list(dict.fromkeys(q for q, _ in pairs))
        a_texts = list(dict.fromkeys(a for _, a in pairs))
        q_pos = {t: i for i, t in enumerate(q_texts)}
        a_pos = {t: i for i, t in enumerate(a_texts)}
        q_idx = np.asarray([q_pos[q] for q, _ in pairs])
        a_idx = np.asarray([a_pos[a] for _, a in pairs])
        q_states = [self._word_state(t) for t in q_texts]
        a_states = [self._word_state(t) for t in a_texts]
        out = np.empty((len(pairs), 4), np.float32)
        for j in (0, 1):
            vocab: Dict[str, int] = {}
            for states in (q_states, a_states):
                for st in states:
                    for w in st[j][0]:
                        vocab.setdefault(w, len(vocab))
            n_words = max(len(vocab), 1)
            q_mat = np.zeros((len(q_texts), n_words))
            a_mat = np.zeros((len(a_texts), n_words))
            for i, st in enumerate(q_states):
                for w in st[j][0]:
                    q_mat[i, vocab[w]] = 1.0
            for i, st in enumerate(a_states):
                for w in st[j][0]:
                    a_mat[i, vocab[w]] = 1.0
            idf_vec = np.zeros((n_words,))
            for w, i in vocab.items():
                idf_vec[i] = self.idf.get(w, 0.0)
            inter = q_mat @ a_mat.T                       # exact small counts
            widf = (q_mat * idf_vec) @ a_mat.T
            qs_len = np.maximum(q_mat.sum(axis=1), 1.0)
            denom_idf = (q_mat * idf_vec).sum(axis=1)
            denom_idf = np.where(denom_idf == 0.0, 1.0, denom_idf)
            out[:, 2 * j] = (inter / qs_len[:, None])[q_idx, a_idx]
            out[:, 2 * j + 1] = (widf / denom_idf[:, None])[q_idx, a_idx]
        return out

    def stats(self) -> Dict[str, float]:
        h = self._tok_cache.hits + self._pair_cache.hits
        m = self._tok_cache.misses + self._pair_cache.misses
        return {"feat_cache_hits": float(h), "feat_cache_misses": float(m),
                "feat_cache_hit_rate": float(h) / max(h + m, 1)}
