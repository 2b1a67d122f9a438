"""Data pipeline: deterministic synthetic LM corpora + per-worker sharding.

A numpy copy of the reference pipeline, so that the token streams of the two
packages are identical byte for byte from the same seeds:

  * ``MarkovCorpus`` — an order-2 token-level Markov chain with a sparse
    random transition kernel.  Its table is ``(vocab, vocab, branch)`` int64,
    so it only suits small vocabularies (50,257 tokens would need ~160 GB).
  * ``TextCorpus``   — byte-level corpus from any file tree (vocab 256).

Batches are yielded in the DSM layout (W, tau, accum, B_micro, S): worker i
always consumes stream shard i.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator

import numpy as np


class MarkovCorpus:
    """Order-2 Markov chain over ``vocab`` tokens with ``branch`` choices."""

    def __init__(self, vocab: int, branch: int = 8, seed: int = 0):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        # transition table: (vocab, vocab) -> `branch` next tokens + probs
        self.next_tokens = rng.integers(0, vocab, size=(vocab, vocab, branch))
        p = rng.dirichlet(np.ones(branch) * 0.5, size=(vocab, vocab))
        self.next_cdf = np.cumsum(p, axis=-1)

    @staticmethod
    def table_bytes(vocab: int, branch: int = 8) -> int:
        """Host bytes of the transition table (int64 tokens + f64 cdf)."""
        return vocab * vocab * branch * 16

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), dtype=np.int32)
        out[:, 0] = rng.integers(0, self.vocab, size=batch)
        out[:, 1] = rng.integers(0, self.vocab, size=batch)
        u = rng.random(size=(batch, seq))
        for t in range(2, seq):
            a, b = out[:, t - 2], out[:, t - 1]
            cdf = self.next_cdf[a, b]                       # (batch, branch)
            idx = (u[:, t : t + 1] > cdf).sum(axis=-1)
            out[:, t] = self.next_tokens[a, b, idx]
        return out


class TextCorpus:
    """Byte-level corpus over a directory of text files (vocab 256)."""

    def __init__(self, root: str = ".", pattern: str = "**/*.py", max_bytes: int = 8_000_000):
        files = sorted(glob.glob(os.path.join(root, pattern), recursive=True))
        buf = []
        total = 0
        for f in files:
            try:
                with open(f, "rb") as fh:
                    b = fh.read()
            except OSError:
                continue
            buf.append(b)
            total += len(b)
            if total >= max_bytes:
                break
        data = b"\n".join(buf)
        if len(data) < 65536:
            raise ValueError(f"corpus too small: {len(data)} bytes from {root}/{pattern}")
        self.data = np.frombuffer(data, dtype=np.uint8).astype(np.int32)
        self.vocab = 256

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        starts = rng.integers(0, len(self.data) - seq - 1, size=batch)
        return np.stack([self.data[s : s + seq] for s in starts])


def dsm_batches(
    corpus,
    n_workers: int,
    tau: int,
    accum: int,
    b_micro: int,
    seq: int,
    seed: int = 0,
    heterogeneous: bool = True,
) -> Iterator[dict]:
    """Yield DSM outer-step batches {tokens: (W, tau, accum, B_micro, S)}.

    ``heterogeneous``: each worker draws from its own stream (paper's D_i);
    otherwise all workers share one stream (iid split).
    """
    rngs = [np.random.default_rng(seed + (i if heterogeneous else 0) * 1009 + 1)
            for i in range(n_workers)]
    while True:
        tokens = np.stack([
            corpus.sample(rngs[i], tau * accum * b_micro, seq)
            .reshape(tau, accum, b_micro, seq)
            for i in range(n_workers)
        ])
        yield {"tokens": tokens}


def eval_batch(corpus, batch: int, seq: int, seed: int = 10_000) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": corpus.sample(rng, batch, seq)}
