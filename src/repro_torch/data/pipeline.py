"""Synthetic LM data pipeline: deterministic, seeded, infinite stream of
(tokens, labels) batches with a learnable structure (piecewise-repeating
n-gram process), so small-model training shows a real loss curve without
external datasets.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    ngram: int = 3


class SyntheticLM:
    """Markov chain over the vocab with sparse transitions — compressible
    structure a model can learn (loss drops well below uniform entropy)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        k = min(8, V)   # successors per state
        self.successors = rng.integers(0, V, size=(V, k))
        self.weights = rng.dirichlet(np.ones(k), size=V)

    def _sample_row(self, rng, n: int) -> np.ndarray:
        V = self.cfg.vocab_size
        out = np.empty(n + 1, dtype=np.int32)
        s = rng.integers(0, V)
        for i in range(n + 1):
            out[i] = s
            nxt = rng.choice(self.successors.shape[1], p=self.weights[s])
            s = self.successors[s, nxt]
        return out

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.cfg.seed + 1)
        B, S = self.cfg.batch_size, self.cfg.seq_len
        while True:
            rows = np.stack([self._sample_row(rng, S) for _ in range(B)])
            yield rows[:, :-1].astype(np.int32), rows[:, 1:].astype(np.int32)
