"""The port's BM25 against ``repro.core.bm25``: identical doc ids (ties
broken to the lower id, as ``jax.lax.top_k`` does) and allclose scores."""
import numpy as np
import pytest
import torch

from repro.core import bm25 as jax_bm25
from repro.data import qa as jax_qa
from repro.data.tokenizer import HashingTokenizer as JaxTokenizer
from repro_torch.core import bm25


@pytest.fixture(scope="module")
def world():
    corpus = jax_qa.generate_corpus(n_docs=120, n_questions=24, seed=4)
    tok = JaxTokenizer(2000)
    docs = [tok.encode(" ".join(d)) for d in corpus.documents]
    jidx = jax_bm25.build_index(docs, tok.vocab_size)
    idx = bm25.build_index(docs, tok.vocab_size)
    queries = [tok.encode(q) for q in corpus.questions]
    # few matching docs (fewer than h), one unknown term, and no terms at all
    queries += [[docs[7][0]], [tok.vocab_size + 5, docs[3][1]], []]
    return jidx, idx, queries


def test_index_arrays_equal(world):
    jidx, idx, _ = world
    for name in ("term_ptr", "post_docs", "post_tf", "idf", "doc_len"):
        np.testing.assert_array_equal(getattr(idx, name), getattr(jidx, name))
    assert idx.avg_dl == jidx.avg_dl and idx.n_docs == jidx.n_docs


@pytest.mark.parametrize("h", [5, 20])
def test_retrieve_matches_jax(world, h):
    jidx, idx, queries = world
    for terms in queries:
        js, jids = jax_bm25.retrieve(jidx, terms, h)
        s, ids = bm25.retrieve(idx, terms, h, device="cpu")
        np.testing.assert_array_equal(ids, np.asarray(jids))
        np.testing.assert_allclose(s, np.asarray(js), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("h", [5, 20])
def test_retrieve_many_matches_jax_and_retrieve(world, h):
    jidx, idx, queries = world
    want = jax_bm25.retrieve_many(jidx, queries, h)
    got = bm25.retrieve_many(idx, queries, h, device="cpu")
    assert len(got) == len(want) == len(queries)
    for terms, (s, ids), (js, jids) in zip(queries, got, want):
        np.testing.assert_array_equal(ids, np.asarray(jids))
        np.testing.assert_allclose(s, np.asarray(js), rtol=1e-6, atol=1e-7)
        one_s, one_ids = bm25.retrieve(idx, terms, h, device="cpu")
        np.testing.assert_array_equal(ids, one_ids)
        np.testing.assert_array_equal(s, one_s)


def test_ties_go_to_the_lower_doc_id():
    # four identical documents: every score ties, ids must come out sorted
    docs = [[3, 4, 4], [5], [3, 4, 4], [3, 4, 4], [3, 4, 4]]
    idx = bm25.build_index(docs, 8)
    s, ids = bm25.retrieve(idx, [3, 4], 4, device="cpu")
    np.testing.assert_array_equal(ids, [0, 2, 3, 4])
    assert len(set(s.tolist())) == 1
    jids = np.asarray(jax_bm25.retrieve(jax_bm25.build_index(docs, 8), [3, 4], 4)[1])
    np.testing.assert_array_equal(ids, jids)


def test_segment_sum_adds_in_posting_order():
    # values whose float32 sum depends on the order of addition
    contrib = torch.tensor([1e8, 1.0, -1e8, 1.0, 3.0], dtype=torch.float32)
    seg = torch.tensor([2, 2, 2, 2, 0])
    valid = torch.ones(5, dtype=torch.bool)
    out = bm25._segment_sum(contrib, seg, valid, 3)
    want = np.float32(0)
    for c in [1e8, 1.0, -1e8, 1.0]:
        want = np.float32(want + np.float32(c))
    assert out[2].item() == float(want) and out[0].item() == 3.0


def test_retrieve_raises_without_a_card_unless_asked_for_cpu(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    _, idx, queries = world
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bm25.retrieve(idx, queries[0], 5)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bm25.retrieve_many(idx, queries[:2], 5)
