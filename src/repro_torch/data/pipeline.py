"""Deterministic, resumable data pipeline: the reference's SyntheticLM.

A seeded zipf-over-vocab token stream with induced bigram structure (so the
loss falls during a short run), generated on the fly from (seed, step) --
resume == set the step.  It is numpy, as in the reference
(``repro.data.pipeline.SyntheticLM``), so both packages see byte-identical
batches.  Batches are the dict the train step consumes: tokens / targets /
loss_mask.  The reference's memory-mapped ``PackedFile`` is not ported yet
(ROADMAP.md Queue 1 item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1
    step: int = 0  # resume cursor

    def state(self) -> dict[str, Any]:
        return {"step": self.step, "seed": self.seed}

    def load_state(self, st: dict[str, Any]) -> None:
        self.step = int(st["step"])
        self.seed = int(st["seed"])

    def _probs(self) -> np.ndarray:
        r = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        p = r ** (-self.zipf_alpha)
        return p / p.sum()

    def next_batch(self) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed * 1_000_003 + self.step) & 0x7FFFFFFF)
        p = self._probs()
        b, s = self.global_batch, self.seq_len
        base = rng.choice(self.vocab_size, size=(b, s + 1), p=p)
        # induce learnable structure: token[t+1] is correlated with token[t]
        mix = rng.random((b, s + 1)) < 0.5
        shifted = (base + 7) % self.vocab_size
        seq = np.where(mix, base, np.roll(shifted, 1, axis=1))
        self.step += 1
        return {
            "tokens": seq[:, :-1].astype(np.int32),
            "targets": seq[:, 1:].astype(np.int32),
            "loss_mask": np.ones((b, s), np.float32),
        }

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
