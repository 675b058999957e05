"""The one traffic generator.  A traffic file (`chipbench/traffic/*.json`)
holds parameters only; everything drawn here is a pure function of the
run's seed and the parameters, so the same seed gives the same inputs,
and every seed gives the same sizes in another order.

Two kinds of input:

- a token stream for training (`LMStream`): (batch, seq) tokens of the
  vocabulary, each row a block-repetitive sequence (a block of
  ``block`` copies of one draw, with a ``noise`` share of tokens drawn
  afresh), labels the tokens shifted by one, as the port's own synthetic
  pipeline draws them;
- conversations for serving (`Conversations`): per session and turn, a
  (requests, prompt_tokens) prompt whose first ``shared_prefix_tokens``
  are one draw shared by every request of every session (a system
  prompt), the rest the request's own.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

#: stream tags that keep the draws of one seed apart
_BATCH, _PREFIX, _TURN, _SAMPLE = 1, 2, 3, 4


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2**63 - 1), *tags])


class LMStream:
    def __init__(self, p: Dict, vocab: int, seed: int) -> None:
        self.batch, self.seq = int(p["batch"]), int(p["seq_len"])
        self.block = int(p.get("block", 8))
        self.noise = float(p.get("noise", 0.1))
        self.vocab, self.seed = vocab, seed

    def __call__(self, step: int) -> Dict[str, np.ndarray]:
        g = rng(self.seed, _BATCH, step)
        b, s, v = self.batch, self.seq, self.vocab
        base = g.integers(0, v, size=(b, -(-s // self.block) + 1))
        tokens = np.repeat(base, self.block, axis=1)[:, :s]
        fresh = g.integers(0, v, size=(b, s))
        tokens = np.where(g.random((b, s)) < self.noise, fresh, tokens)
        tokens = tokens.astype(np.int32)
        return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


class Conversations:
    def __init__(self, p: Dict, vocab: int, seed: int) -> None:
        self.requests = int(p["requests"])
        self.prompt = int(p["prompt_tokens"])
        self.shared = int(p["shared_prefix_tokens"])
        if not 0 <= self.shared <= self.prompt:
            raise ValueError("shared_prefix_tokens must lie in "
                             "[0, prompt_tokens]")
        self.vocab, self.seed = vocab, seed
        self.prefix = rng(seed, _PREFIX).integers(0, vocab, size=self.shared)

    def __call__(self, session: int, turn: int) -> np.ndarray:
        own = rng(self.seed, _TURN, session, turn).integers(
            0, self.vocab, size=(self.requests, self.prompt - self.shared))
        pre = np.broadcast_to(self.prefix, (self.requests, self.shared))
        return np.concatenate([pre, own], axis=1).astype(np.int32)


def sample(seed: int, tag: int, population: int, k: int) -> List[int]:
    """k distinct indices of range(population) drawn from the seed (all
    of them when k >= population), sorted."""
    k = min(k, population)
    return sorted(int(i) for i in rng(seed, _SAMPLE, tag).choice(
        population, size=k, replace=False))


def trained_prefixes(spec: Dict, n_layers: int) -> List[str]:
    """Parameter prefixes a fine-tune trains: the top ``top_layers``
    layers (all of them for ``"all"``), and the final norm and the
    embedding where flagged."""
    top = spec["top_layers"]
    top = n_layers if top == "all" else int(top)
    out = [f"layers/{i}" for i in range(n_layers - top, n_layers)]
    if spec.get("final_norm", True):
        out.append("final_norm")
    if spec.get("embed", False):
        out.append("embed")
    return out


def frozen_prefixes(trained: Sequence[str], top_level: Sequence[str],
                    n_layers: int) -> List[str]:
    """The complement of `trained` among the parameter groups."""
    groups = [g for g in top_level if g != "layers"] + \
        [f"layers/{i}" for i in range(n_layers)]
    return [g for g in groups if g not in trained]
