"""Hashing tokenizer + stopword list (offline container: no external vocabs)."""
from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np

STOPWORDS = frozenset(
    "a an and are as at be by for from has he in is it its of on that the to "
    "was were will with what when where who why how which this these those i "
    "you your we they them his her do does did not no or if then than so such "
    "can could would should may might must have had having been being".split())

_TOKEN_RE = re.compile(r"[a-z0-9']+")


class HashingTokenizer:
    """Stable hashing tokenizer: token -> bucket in [n_special, vocab_size).

    id 0 = PAD, id 1 = UNK/OOV-reserved; hashing is FNV-1a for determinism
    across processes (python hash() is salted).
    """
    PAD = 0
    UNK = 1
    N_SPECIAL = 2

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    @staticmethod
    def words(text: str) -> List[str]:
        return _TOKEN_RE.findall(text.lower())

    def _hash(self, w: str) -> int:
        h = 0xcbf29ce484222325
        for ch in w.encode():
            h = ((h ^ ch) * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
        return self.N_SPECIAL + h % (self.vocab_size - self.N_SPECIAL)

    def encode(self, text: str, max_len: int = 0) -> List[int]:
        ids = [self._hash(w) for w in self.words(text)]
        if max_len:
            ids = ids[:max_len] + [self.PAD] * max(0, max_len - len(ids))
        return ids

    def encode_batch(self, texts: Sequence[str], max_len: int) -> np.ndarray:
        return np.asarray([self.encode(t, max_len) for t in texts], np.int32)


def overlap_features(q_words: Sequence[str], a_words: Sequence[str],
                     idf: dict) -> np.ndarray:
    """The paper's 4 extra features: word overlap and idf-weighted word
    overlap, over all words and over non-stopwords only."""
    feats = np.zeros((4,), np.float32)
    for j, filt in enumerate((False, True)):
        qs = {w for w in q_words if not (filt and w in STOPWORDS)}
        as_ = {w for w in a_words if not (filt and w in STOPWORDS)}
        inter = qs & as_
        denom = max(len(qs), 1)
        feats[2 * j] = len(inter) / denom
        widf = sum(idf.get(w, 0.0) for w in inter)
        denom_idf = sum(idf.get(w, 0.0) for w in qs) or 1.0
        feats[2 * j + 1] = widf / denom_idf
    return feats
