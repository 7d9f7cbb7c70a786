"""Deterministic synthetic data pipeline: the port's own copy of
``repro.data.pipeline``, numpy only, giving bit-identical batches.

Step-indexed PRNG makes every batch a pure function of (seed, step,
shard), so training is bit-reproducible across restarts and elastic
re-shardings: after restoring a checkpoint at step k the pipeline
resumes from batch k with no state to save.  Host sharding follows the
(process_index, process_count) contract so multi-host launches read
disjoint shards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # Markov-chain synthetic text: learnable structure so loss can fall
    order_bias: float = 0.8


class SyntheticLM:
    """Zipfian tokens with a first-order Markov structure (so a model
    trained on it has signal to fit — loss decreases measurably)."""

    def __init__(self, cfg: DataConfig, process_index: int = 0, process_count: int = 1):
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        if cfg.global_batch % process_count:
            raise ValueError("global_batch must divide process_count")
        self.local_batch = cfg.global_batch // process_count
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self._zipf = 1.0 / np.arange(1, v + 1)
        self._zipf /= self._zipf.sum()
        self._perm = base.permutation(v)  # next-token mapping

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.cfg.seed, step, self.process_index, 0xD47A)
        )
        b, t, v = self.local_batch, self.cfg.seq_len, self.cfg.vocab_size
        toks = np.empty((b, t), np.int32)
        toks[:, 0] = rng.choice(v, size=b, p=self._zipf)
        flips = rng.random((b, t)) < self.cfg.order_bias
        rand = rng.choice(v, size=(b, t), p=self._zipf)
        for i in range(1, t):
            toks[:, i] = np.where(flips[:, i], self._perm[toks[:, i - 1]], rand[:, i])
        labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
        return {"tokens": toks, "labels": labels}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
