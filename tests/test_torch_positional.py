"""The port's positional index against the JAX package (CPU).

``repro_torch.index.positional`` must build the same corpus and the same
compressed position lists as ``repro.index.positional`` from the same
seed, and answer every phrase query exactly as it does and as the
brute-force oracle of ``tests/test_positional.py`` does, by both the
``lookup`` and the ``skip`` strategies.
"""

import numpy as np
import pytest

from repro.index.positional import PositionalIndex as PositionalJax
from repro.index.positional import positional_corpus as corpus_jax

from repro_torch.index.positional import PositionalIndex, positional_corpus


@pytest.fixture(scope="module")
def pidx():
    corpus = positional_corpus(num_docs=200, vocab_size=500,
                               mean_doc_len=80, seed=3)
    ref_corpus = corpus_jax(num_docs=200, vocab_size=500, mean_doc_len=80,
                            seed=3)
    assert corpus.stride == ref_corpus.stride
    for a, b in zip(corpus.doc_tokens, ref_corpus.doc_tokens, strict=True):
        np.testing.assert_array_equal(a, b)
    return corpus, PositionalIndex(corpus), PositionalJax(ref_corpus)


def _phrase_oracle(corpus, terms):
    out = []
    t = np.asarray(terms)
    for d, toks in enumerate(corpus.doc_tokens):
        n, m = len(toks), len(t)
        for s in range(n - m + 1):
            if np.array_equal(toks[s:s + m], t):
                out.append(d)
                break
    return np.asarray(out, dtype=np.int64)


def test_same_index_as_repro(pidx):
    _, ix, ref = pidx
    np.testing.assert_array_equal(ix.terms, ref.terms)
    np.testing.assert_array_equal(ix.repair.seq, ref.repair.seq)
    np.testing.assert_array_equal(ix.repair.grammar.rules,
                                  ref.repair.grammar.rules)
    assert ix.space_bits() == ref.space_bits()
    for term in (int(ix.terms[0]), int(ix.terms[7]), int(ix.terms[-1])):
        np.testing.assert_array_equal(ix.positions(term),
                                      ref.positions(term))


@pytest.mark.parametrize("method", ["lookup", "skip"])
@pytest.mark.parametrize("length", [2, 3])
def test_phrases_match_repro_and_oracle(pidx, length, method):
    corpus, ix, ref = pidx
    rng = np.random.default_rng(length * 10 + len(method))
    found = 0
    for _ in range(30):
        t0 = int(rng.integers(0, 40))
        terms = [(t0 + j) % corpus.vocab_size for j in range(length)]
        got = ix.phrase(terms, method=method)
        np.testing.assert_array_equal(got, ref.phrase(terms, method=method))
        np.testing.assert_array_equal(got, _phrase_oracle(corpus, terms))
        found += int(got.size > 0)
    assert found > 0                      # real phrases were exercised


def test_unknown_term_and_single_term(pidx):
    corpus, ix, ref = pidx
    missing = corpus.vocab_size + 5
    assert ix.phrase([0, missing]).size == 0 == ref.phrase([0, missing]).size
    assert ix.positions(missing).size == 0
    np.testing.assert_array_equal(ix.phrase([5]), ref.phrase([5]))
    np.testing.assert_array_equal(ix.phrase([5]), _phrase_oracle(corpus, [5]))
