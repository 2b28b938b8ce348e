"""Stage-1 candidate generation: BM25 over a packed doc-term index.

Index construction is host-side numpy (inverted lists are inherently ragged);
scoring runs on the device over the query's concatenated postings:
``score contributions = idf * tf_saturation``, summed per document with a
float32 scatter-add (``index_add_``) and cut to top-h.

Two choices keep the rankings identical to the JAX package's and identical
between ``retrieve`` and ``retrieve_many``:

  * Sums are taken in posting order, like a sequential ``segment_sum``. A
    document's contributions are added in rounds: round r adds every
    document's r-th posting, so within a round no two additions hit one
    document, and each document's sum is ``((0 + c0) + c1) + ...`` whatever
    order the card's atomics take. The card would otherwise round equal
    scores differently from run to run, and a tie at the h-th place could
    change which documents are retrieved.
  * Top-h orders ties with the lower doc id first, as ``jax.lax.top_k``
    does: a stable descending sort, sliced (``torch.topk`` promises no tie
    order).

Postings for a query are padded to a power-of-two budget, and query batches
to a power-of-two count, as in the JAX package; padding contributes nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

K1 = 0.9
B = 0.4


@dataclasses.dataclass
class BM25Index:
    term_ptr: np.ndarray      # (V+1,) CSR pointer into postings
    post_docs: np.ndarray     # (nnz,) doc ids
    post_tf: np.ndarray       # (nnz,) term frequencies
    idf: np.ndarray           # (V,)
    doc_len: np.ndarray       # (N,)
    avg_dl: float
    n_docs: int

    @property
    def vocab_size(self) -> int:
        return len(self.term_ptr) - 1


def build_index(docs_tokens: Sequence[Sequence[int]], vocab_size: int) -> BM25Index:
    n_docs = len(docs_tokens)
    doc_len = np.asarray([len(d) for d in docs_tokens], np.float32)
    # term -> [(doc, tf)]
    postings: Dict[int, Dict[int, int]] = {}
    for di, toks in enumerate(docs_tokens):
        for t in toks:
            postings.setdefault(int(t), {})
            postings[int(t)][di] = postings[int(t)].get(di, 0) + 1
    term_ptr = np.zeros((vocab_size + 1,), np.int64)
    for t, plist in postings.items():
        term_ptr[t + 1] = len(plist)
    term_ptr = np.cumsum(term_ptr)
    nnz = int(term_ptr[-1])
    post_docs = np.zeros((nnz,), np.int32)
    post_tf = np.zeros((nnz,), np.float32)
    for t, plist in postings.items():
        s = term_ptr[t]
        for i, (di, tf) in enumerate(sorted(plist.items())):
            post_docs[s + i] = di
            post_tf[s + i] = tf
    df = np.diff(term_ptr).astype(np.float32)
    idf = np.log((n_docs - df + 0.5) / (df + 0.5) + 1.0).astype(np.float32)
    return BM25Index(term_ptr, post_docs, post_tf, idf, doc_len,
                     float(doc_len.mean() or 1.0), n_docs)


def gather_query_postings(index: BM25Index, query_terms: Sequence[int],
                          budget: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side ragged gather -> fixed-size (docs, tf, idf_per_posting)."""
    docs, tfs, idfs = [], [], []
    for t in query_terms:
        if t < 0 or t >= index.vocab_size:
            continue
        s, e = int(index.term_ptr[t]), int(index.term_ptr[t + 1])
        docs.append(index.post_docs[s:e])
        tfs.append(index.post_tf[s:e])
        idfs.append(np.full((e - s,), index.idf[t], np.float32))
    if docs:
        docs = np.concatenate(docs)[:budget]
        tfs = np.concatenate(tfs)[:budget]
        idfs = np.concatenate(idfs)[:budget]
    else:
        docs = np.zeros((0,), np.int32)
        tfs = np.zeros((0,), np.float32)
        idfs = np.zeros((0,), np.float32)
    pad = budget - len(docs)
    # padding postings point at doc 0 with idf 0 -> zero contribution
    docs = np.concatenate([docs, np.zeros((pad,), np.int32)])
    tfs = np.concatenate([tfs, np.zeros((pad,), np.float32)])
    idfs = np.concatenate([idfs, np.zeros((pad,), np.float32)])
    return docs.astype(np.int32), tfs, idfs


def _occurrence_rank(seg: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """For each posting, how many earlier valid postings share its segment
    (0 for the first); padding postings get 0."""
    n = seg.numel()
    key = torch.where(valid, seg, torch.full_like(seg, -1))
    sorted_key, order = torch.sort(key, stable=True)
    pos = torch.arange(n, device=seg.device)
    starts = torch.ones(n, dtype=torch.bool, device=seg.device)
    starts[1:] = sorted_key[1:] != sorted_key[:-1]
    first = torch.cummax(torch.where(starts, pos, torch.zeros_like(pos)), 0).values
    rank = torch.empty_like(pos).scatter_(0, order, pos - first)
    return torch.where(valid, rank, torch.zeros_like(rank))


def _segment_sum(contrib: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """``segment_sum`` in float32 that adds each segment's values in their
    order along ``contrib`` (see the module doc)."""
    out = torch.zeros((num_segments,), dtype=torch.float32, device=contrib.device)
    if not bool(valid.any()):
        return out
    rank = _occurrence_rank(seg, valid)
    zero = torch.zeros_like(contrib)
    for r in range(int(rank.max()) + 1):
        # one nonzero addend per segment; the others add exact zeros
        out.index_add_(0, seg, torch.where(valid & (rank == r), contrib, zero))
    return out


def _top_k(scores: torch.Tensor, h: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-h along the last axis, ties to the lower index (jax.lax.top_k)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :h], idx[..., :h]


def _contributions(post_docs, post_tf, post_idf, doc_len, avg_dl):
    norm = K1 * (1.0 - B + B * doc_len[post_docs] / avg_dl)
    return post_idf * post_tf * (K1 + 1.0) / (post_tf + norm)


def _score_postings(post_docs, post_tf, post_idf, doc_len, avg_dl, h):
    contrib = _contributions(post_docs, post_tf, post_idf, doc_len, avg_dl)
    scores = _segment_sum(contrib, post_docs, post_tf > 0, doc_len.shape[0])
    return _top_k(scores, h)


def _score_postings_many(post_docs, post_tf, post_idf, doc_len, avg_dl, h):
    """(Q, P) postings -> per-query top-h. One segment sum over a flattened
    (query, doc) segment id space instead of Q separate calls."""
    q, p = post_docs.shape
    n_docs = doc_len.shape[0]
    contrib = _contributions(post_docs, post_tf, post_idf, doc_len, avg_dl)
    seg = post_docs + torch.arange(q, dtype=post_docs.dtype,
                                   device=post_docs.device)[:, None] * n_docs
    scores = _segment_sum(contrib.reshape(-1), seg.reshape(-1),
                          (post_tf > 0).reshape(-1), q * n_docs).reshape(q, n_docs)
    return _top_k(scores, h)


def _to_device(dev: torch.device, *arrays: np.ndarray) -> List[torch.Tensor]:
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def retrieve(index: BM25Index, query_terms: Sequence[int], h: int,
             budget: int = 16384, device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Top-h (scores, doc_ids) for a query, scored on ``device``."""
    dev = resolve_device(device)
    docs, tfs, idfs = gather_query_postings(index, query_terms, budget)
    docs_t, tfs_t, idfs_t, doc_len = _to_device(dev, docs.astype(np.int64), tfs,
                                                idfs, index.doc_len)
    scores, ids = _score_postings(docs_t, tfs_t, idfs_t, doc_len, index.avg_dl, h)
    return scores.cpu().numpy(), ids.to(torch.int32).cpu().numpy()


def _pad_bucket(n: int, lo: int = 256) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def retrieve_many(index: BM25Index, queries_terms: Sequence[Sequence[int]],
                  h: int, budget: int = 16384, device="cuda"
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Batched ``retrieve``: same per-query (scores, doc_ids), one padded
    (Q, P) scoring call. Both dims are bucketed to powers of two (all-zero
    padding rows/columns contribute nothing and padded-query results are
    discarded)."""
    dev = resolve_device(device)
    if not queries_terms:
        return []
    gathered = [gather_query_postings(index, t, budget) for t in queries_terms]
    # gather pads each to `budget`; trim to the batch max, then re-bucket
    # (real postings always have tf > 0, padding is all-zero)
    nnz = [int(np.count_nonzero(g[1])) for g in gathered]
    p = min(budget, _pad_bucket(max(max(nnz), 1)))
    qb = _pad_bucket(len(gathered), lo=8)
    pad_rows = [(np.zeros((p,), np.int32), np.zeros((p,), np.float32),
                 np.zeros((p,), np.float32))] * (qb - len(gathered))
    docs = np.stack([g[0][:p] for g in gathered + pad_rows]).astype(np.int64)
    tfs = np.stack([g[1][:p] for g in gathered + pad_rows])
    idfs = np.stack([g[2][:p] for g in gathered + pad_rows])
    docs_t, tfs_t, idfs_t, doc_len = _to_device(dev, docs, tfs, idfs, index.doc_len)
    scores, ids = _score_postings_many(docs_t, tfs_t, idfs_t, doc_len,
                                       index.avg_dl, h)
    scores, ids = scores.cpu().numpy(), ids.to(torch.int32).cpu().numpy()
    return [(scores[i], ids[i]) for i in range(len(gathered))]
