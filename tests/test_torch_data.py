"""The port's copies of the data modules give the JAX package's arrays."""
import numpy as np
import pytest

from repro.data import featurize as jax_featurize, qa as jax_qa
from repro.data.tokenizer import HashingTokenizer as JaxTokenizer
from repro.data.tokenizer import overlap_features as jax_overlap
from repro_torch.data import featurize, qa
from repro_torch.data.tokenizer import HashingTokenizer, overlap_features


@pytest.fixture(scope="module", params=[0, 11])
def corpora(request):
    kw = dict(n_docs=30, n_questions=12, seed=request.param)
    return qa.generate_corpus(**kw), jax_qa.generate_corpus(**kw)


def test_corpus_is_identical(corpora):
    mine, ref = corpora
    assert mine.documents == ref.documents
    assert mine.questions == ref.questions
    assert mine.pairs == ref.pairs
    assert mine.idf == ref.idf
    assert mine.entities == ref.entities


@pytest.mark.parametrize("vocab,max_len", [(200, 16), (30000, 64)])
def test_token_rows_and_overlap_features_equal(corpora, vocab, max_len):
    mine, ref = corpora
    tok, jtok = HashingTokenizer(vocab), JaxTokenizer(vocab)
    texts = mine.questions + [s for d in mine.documents for s in d]
    np.testing.assert_array_equal(tok.encode_batch(texts, max_len),
                                  jtok.encode_batch(texts, max_len))
    for q in mine.questions[:4]:
        for s in mine.documents[0]:
            np.testing.assert_array_equal(
                overlap_features(tok.words(q), tok.words(s), mine.idf),
                jax_overlap(jtok.words(q), jtok.words(s), ref.idf))


def test_make_batch_and_pair_batches_equal(corpora):
    mine, ref = corpora
    tok, jtok = HashingTokenizer(200), JaxTokenizer(200)
    a = qa.make_batch(mine, tok, 16, mine.pairs[:10])
    b = jax_qa.make_batch(ref, jtok, 16, ref.pairs[:10])
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for x, y in zip(qa.pair_batches(mine, tok, 16, 8, seed=2),
                    jax_qa.pair_batches(ref, jtok, 16, 8, seed=2)):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_pair_feats_many_equal(corpora):
    mine, ref = corpora
    cache = featurize.FeaturizationCache(HashingTokenizer(200), mine.idf, 16)
    jcache = jax_featurize.FeaturizationCache(JaxTokenizer(200), ref.idf, 16)
    pairs = [(q, s) for q in mine.questions[:6] for d in mine.documents[:3]
             for s in d]
    got = cache.pair_feats_many(pairs)
    np.testing.assert_array_equal(got, jcache.pair_feats_many(pairs))
    # cached second pass and the scalar form agree with the first
    np.testing.assert_array_equal(cache.pair_feats_many(pairs), got)
    np.testing.assert_allclose(np.stack([cache.pair_feats(q, a) for q, a in pairs]),
                               got, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(cache.query_row(pairs[0][0]),
                                  jcache.query_row(pairs[0][0]))
    assert cache.stats()["feat_cache_hits"] > 0
