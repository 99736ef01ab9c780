"""Deterministic synthetic token pipeline (host-side numpy).

Generates a reproducible stream: the batch for (seed, step) is identical
across restarts, so a resumed run sees the batches an uninterrupted one
would. Labels are next-token shifted, with a structured bigram pattern so a
training run has real signal to fit.

(Copied from ``repro/data/synthetic.py`` so this package imports nothing
of the JAX package; only the module docstring differs. Its batches equal
the reference's bit for bit.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    pattern_order: int = 2  # markov order of the synthetic language


class SyntheticDataset:
    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # sparse deterministic bigram table: each token has 4 likely successors
        self.succ = rng.integers(0, v, size=(v, 4))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        choice = rng.integers(0, 4, size=(b, s))
        noise = rng.random((b, s)) < 0.1
        rand_tok = rng.integers(0, v, size=(b, s))
        for t in range(s):
            nxt = self.succ[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
