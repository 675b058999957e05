"""Deterministic, resumable, sharded synthetic token pipeline: the
port's copy of `repro.train.data`, numpy only, so batches and cursors are
bit-equal to the reference's.

Production posture: each host draws only its addressable slice of the
global batch (host-sharded loading); the cursor state is a tiny host-side
pytree that Chipmink checkpoints alongside device state (the paper's
"objects span various locations" point — persistence must cover host state
too).  Resuming from (seed, step) is exact: batches are a pure function of
the cursor, so restart/elastic re-mesh reproduce the stream bit-for-bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int
    host_index: int
    host_count: int

    def as_tree(self) -> Dict:
        return {"seed": self.seed, "step": self.step,
                "host_index": self.host_index, "host_count": self.host_count}

    @classmethod
    def from_tree(cls, t: Dict) -> "PipelineState":
        return cls(seed=int(t["seed"]), step=int(t["step"]),
                   host_index=int(t["host_index"]),
                   host_count=int(t["host_count"]))


class TokenPipeline:
    """Markov-ish synthetic LM stream (structured enough that loss falls)."""

    def __init__(self, vocab: int, global_batch: int, seq_len: int,
                 seed: int = 0, host_index: int = 0, host_count: int = 1):
        assert global_batch % host_count == 0
        self.vocab = vocab
        self.global_batch = global_batch
        self.local_batch = global_batch // host_count
        self.seq_len = seq_len
        self.state = PipelineState(seed, 0, host_index, host_count)

    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.state.seed, step, self.state.host_index))

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = self._rng_for(self.state.step)
        b, s, v = self.local_batch, self.seq_len, self.vocab
        # block-repetitive stream: learnable local structure
        base = rng.integers(0, v, size=(b, s // 8 + 2), dtype=np.int64)
        tokens = np.repeat(base, 8, axis=1)[:, :s]
        noise = rng.integers(0, v, size=(b, s))
        mask = rng.random((b, s)) < 0.1
        tokens = np.where(mask, noise, tokens).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        self.state.step += 1
        return {"tokens": tokens, "labels": labels}

    # -- persistence (host state saved by Chipmink) -------------------------
    def cursor(self) -> Dict:
        return self.state.as_tree()

    def restore(self, cursor: Dict) -> None:
        self.state = PipelineState.from_tree(cursor)
        assert self.global_batch % self.state.host_count == 0
        self.local_batch = self.global_batch // self.state.host_count
