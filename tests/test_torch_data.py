"""The port's numpy data pipeline yields the JAX package's streams byte for
byte."""

from pathlib import Path

import numpy as np
import pytest

from repro.data import pipeline as JP
from repro_torch.data import pipeline as P

SRC = str(Path(__file__).resolve().parents[1] / "src")


@pytest.mark.parametrize("vocab,branch,seed", [(64, 8, 1), (64, 4, 7), (300, 8, 0)])
def test_markov_corpus_identical(vocab, branch, seed):
    ours, theirs = P.MarkovCorpus(vocab, branch, seed), JP.MarkovCorpus(vocab, branch, seed)
    np.testing.assert_array_equal(ours.next_tokens, theirs.next_tokens)
    np.testing.assert_array_equal(ours.next_cdf, theirs.next_cdf)
    a = ours.sample(np.random.default_rng(3), 5, 33)
    b = theirs.sample(np.random.default_rng(3), 5, 33)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert P.MarkovCorpus.table_bytes(vocab, branch) == (
        ours.next_tokens.nbytes + ours.next_cdf.nbytes)


def test_text_corpus_identical():
    ours, theirs = P.TextCorpus(SRC, "**/*.py"), JP.TextCorpus(SRC, "**/*.py")
    assert ours.data.tobytes() == theirs.data.tobytes() and ours.vocab == theirs.vocab == 256
    a = ours.sample(np.random.default_rng(0), 4, 128)
    b = theirs.sample(np.random.default_rng(0), 4, 128)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("heterogeneous", [True, False])
def test_dsm_batches_and_eval_batch_identical(heterogeneous):
    corpus = P.MarkovCorpus(64, seed=1)
    ours = P.dsm_batches(corpus, 3, 4, 2, 2, 16, seed=5, heterogeneous=heterogeneous)
    theirs = JP.dsm_batches(corpus, 3, 4, 2, 2, 16, seed=5, heterogeneous=heterogeneous)
    for _ in range(3):
        a, b = next(ours)["tokens"], next(theirs)["tokens"]
        assert a.shape == (3, 4, 2, 2, 16) and a.tobytes() == b.tobytes()
    assert (P.eval_batch(corpus, 8, 32)["tokens"].tobytes()
            == JP.eval_batch(corpus, 8, 32)["tokens"].tobytes())
