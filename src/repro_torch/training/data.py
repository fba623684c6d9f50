"""Data pipeline: deterministic synthetic-corpus token stream.

A real deployment would stream tokenised text; the contract requires the
substrate, not a dataset.  The pipeline generates a reproducible corpus
with Zipfian unigram statistics plus Markov bigram structure — enough
signal that the training examples show a genuinely decreasing loss — and
serves fixed-shape batches with host-side prefetch semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticCorpus:
    """Markov-chain corpus with Zipf marginals (learnable structure)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        marginal = ranks ** (-cfg.zipf_a)
        marginal /= marginal.sum()
        # sparse-ish transition structure: each token prefers ~8 successors
        self._succ = rng.integers(0, V, size=(V, 8))
        self._marginal = marginal
        self._rng = rng

    def batches(self) -> Iterator[dict]:
        """Yields {"tokens": [B, S]} — the loss shifts targets internally."""
        cfg = self.cfg
        while True:
            toks = np.empty((cfg.batch_size, cfg.seq_len), np.int32)
            cur = self._rng.choice(cfg.vocab_size, p=self._marginal,
                                   size=cfg.batch_size)
            toks[:, 0] = cur
            for t in range(1, cfg.seq_len):
                stay = self._rng.random(cfg.batch_size) < 0.8
                nxt_idx = self._rng.integers(0, 8, cfg.batch_size)
                markov = self._succ[cur, nxt_idx]
                fresh = self._rng.choice(cfg.vocab_size, p=self._marginal,
                                         size=cfg.batch_size)
                cur = np.where(stay, markov, fresh).astype(np.int32)
                toks[:, t] = cur
            yield {"tokens": toks}
