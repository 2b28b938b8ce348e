"""Synthetic TrecQA-like corpus + QA pairs (offline container: no downloads).

Generates a document collection from a template grammar over a sampled
word list, then derives (question, candidate sentence, label) triples the way
TrecQA does: positives share content terms with the question, negatives are
sampled from retrieved-but-irrelevant sentences. Deterministic via seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.data.tokenizer import HashingTokenizer, overlap_features

_SYLLABLES = ("ba be bi bo bu da de di do du ka ke ki ko ku la le li lo lu "
              "ma me mi mo mu na ne ni no nu ra re ri ro ru sa se si so su "
              "ta te ti to tu va ve vi vo vu za ze zi zo zu").split()
_QWORDS = ("what", "who", "when", "where", "why", "how")
_GLUE = ("the", "of", "in", "is", "was", "a", "and", "to", "for", "on")


def _make_word(rng: np.random.Generator) -> str:
    return "".join(rng.choice(_SYLLABLES) for _ in range(rng.integers(2, 4)))


@dataclasses.dataclass
class QACorpus:
    documents: List[List[str]]          # doc -> sentences (text)
    questions: List[str]
    # (question_idx, doc_idx, sent_idx, label)
    pairs: List[Tuple[int, int, int, int]]
    idf: Dict[str, float]
    entities: List[str]


def generate_corpus(n_docs: int = 200, sents_per_doc: int = 8,
                    n_questions: int = 100, n_entities: int = 150,
                    seed: int = 0) -> QACorpus:
    rng = np.random.default_rng(seed)
    entities = sorted({_make_word(rng) for _ in range(n_entities)})
    facts = {}  # entity -> (relation words, object entity)
    for e in entities:
        facts[e] = (_make_word(rng), entities[rng.integers(len(entities))])

    def sentence(subj: str) -> str:
        rel, obj = facts[subj]
        glue = [str(x) for x in rng.choice(_GLUE, rng.integers(2, 5))]
        extra = [_make_word(rng) for _ in range(rng.integers(0, 3))]
        words = [subj, glue[0], rel, glue[1], obj] + extra + glue[2:]
        return " ".join(words)

    documents = []
    doc_entities = []
    for _ in range(n_docs):
        subj_pool = [entities[rng.integers(len(entities))]
                     for _ in range(sents_per_doc)]
        documents.append([sentence(s) for s in subj_pool])
        doc_entities.append(subj_pool)

    questions, pairs = [], []
    for qi in range(n_questions):
        # ask about a random entity that appears somewhere
        di = int(rng.integers(n_docs))
        si = int(rng.integers(sents_per_doc))
        subj = doc_entities[di][si]
        rel, _ = facts[subj]
        qw = _QWORDS[rng.integers(len(_QWORDS))]
        questions.append(f"{qw} is the {rel} of {subj}")
        # positives: sentences about subj; negatives: other sentences
        for dj, doc in enumerate(documents[:50]):
            for sj, _s in enumerate(doc):
                if doc_entities[dj][sj] == subj:
                    pairs.append((qi, dj, sj, 1))
        pairs.append((qi, di, si, 1))
        for _ in range(6):
            dj = int(rng.integers(n_docs))
            sj = int(rng.integers(sents_per_doc))
            if doc_entities[dj][sj] != subj:
                pairs.append((qi, dj, sj, 0))

    # idf over sentences
    n_sents = n_docs * sents_per_doc
    df: Dict[str, int] = {}
    for doc in documents:
        for s in doc:
            for w in set(s.split()):
                df[w] = df.get(w, 0) + 1
    idf = {w: math.log((n_sents - d + 0.5) / (d + 0.5) + 1.0)
           for w, d in df.items()}
    return QACorpus(documents, questions, pairs, idf, entities)


def pair_batches(corpus: QACorpus, tok: HashingTokenizer, max_len: int,
                 batch_size: int, seed: int = 0, split: str = "train"):
    """Yield training batches of tokenized (q, a, feats, label)."""
    rng = np.random.default_rng(seed)
    pairs = [p for i, p in enumerate(corpus.pairs)
             if (i % 10 != 0) == (split == "train")]
    order = rng.permutation(len(pairs))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        idx = order[i:i + batch_size]
        yield make_batch(corpus, tok, max_len, [pairs[j] for j in idx])


def make_batch(corpus: QACorpus, tok: HashingTokenizer, max_len: int,
               pairs: Sequence[Tuple[int, int, int, int]]) -> Dict[str, np.ndarray]:
    qs, as_, feats, labels = [], [], [], []
    for qi, di, si, lbl in pairs:
        q_text = corpus.questions[qi]
        a_text = corpus.documents[di][si]
        qs.append(q_text)
        as_.append(a_text)
        feats.append(overlap_features(tok.words(q_text), tok.words(a_text),
                                      corpus.idf))
        labels.append(lbl)
    return {
        "q_tok": tok.encode_batch(qs, max_len),
        "a_tok": tok.encode_batch(as_, max_len),
        "feats": np.stack(feats),
        "label": np.asarray(labels, np.int32),
    }
