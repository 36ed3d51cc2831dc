"""Synthetic token pipeline for LM training (port of
`repro/training/data.py`, numpy as the reference: the same seed gives the
same tokens, byte for byte).

A seeded Markov-chain token stream: each vocab id has a small set of likely
successors, so a model can reduce its loss below the unigram entropy (a
learning curve without external datasets).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 1024
    seq_len: int = 256
    batch_size: int = 8
    branching: int = 4          # successors per token
    temperature: float = 0.7
    seed: int = 0


class MarkovTokens:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v, b = cfg.vocab_size, cfg.branching
        self.successors = rng.integers(0, v, size=(v, b))
        logits = rng.normal(size=(v, b)) / cfg.temperature
        p = np.exp(logits - logits.max(1, keepdims=True))
        self.probs = p / p.sum(1, keepdims=True)
        self.rng = rng

    def sample_batch(self) -> Dict[str, np.ndarray]:
        """{"tokens", "labels"}: (batch, seq_len) int32, labels the tokens
        shifted by one."""
        cfg = self.cfg
        b, s = cfg.batch_size, cfg.seq_len
        toks = np.zeros((b, s + 1), np.int64)
        toks[:, 0] = self.rng.integers(0, cfg.vocab_size, size=b)
        for t in range(s):
            cur = toks[:, t]
            choice = np.array([self.rng.choice(cfg.branching, p=self.probs[c])
                               for c in cur])
            toks[:, t + 1] = self.successors[cur, choice]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.sample_batch()
