"""Deterministic synthetic token data pipeline.

Generates reproducible next-token-predictable streams (a mixture of a
Markov-chain "language" and copy motifs) so training loss measurably
decreases — useful for end-to-end validation of the trainer without
shipping a corpus. Batches are yielded as numpy, moved to the device by
the caller (the pipeline is host-side, like a tf.data feed). A copy of
`repro.data.pipeline`, which is numpy only: the same seed gives the same
batches, bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order: int = 1
    branching: int = 8     # successors per state -> learnable structure


class SyntheticTokens:
    """Infinite deterministic stream of (tokens, labels) batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # sparse Markov transition: each token allows `branching` successors
        self._succ = rng.integers(0, v, size=(v, cfg.branching))
        self._step = 0

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + 1 + self._step)
        self._step += 1
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        choices = rng.integers(0, cfg.branching, (b, s))
        for t in range(1, s):
            toks[:, t] = self._succ[toks[:, t - 1], choices[:, t]]
        return {"tokens": toks}


def batches(cfg: DataConfig, n: int):
    it = SyntheticTokens(cfg)
    for _ in range(n):
        yield next(it)
