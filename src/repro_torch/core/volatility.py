"""Composable volatility model (paper §5.2).

Object mutations are modeled as Poisson events with rate λ(u) <= 1 per
step-window; pod volatility composes by summation λ(u_p) = Σ λ(u).

The paper trains LightGBM on lightweight, type-agnostic features (immediate
size, length, __dict__ length).  The save path fits no model: LGA reads the
heuristic prior below, whose feature 9 is the flip-rate EMA that
`FlipTracker` keeps per chunk, or one of the paper's ablation models
(λ≡0 → LGA-0, λ≡1 → LGA-1).

Features per graph node (the training-state analogues of the paper's
size/length/__dict__-length):
    0  log2(size + 1)              (immediate size)
    1  depth (path length)
    2  leading-dim length log2     (object "length")
    3  number of children          (__dict__ length)
    4  is payload chunk
    5  is scalar/counter
    6  dtype class (0 float, 1 int, 2 bool/other)
    7  param-kind: params=0, optimizer slot=1, cache=2, other=3
    8  normalized layer index (digits found in path)
    9  historical flip-rate EMA (0.5 when unknown)
"""
from __future__ import annotations

import re
from itertools import repeat
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from .graph import CHUNK, LEAF, SCALAR, Node, ObjectGraph

N_FEATURES = 10

_FLOAT_RE = re.compile(r"float|bfloat")
_INT_RE = re.compile(r"int")
_LAYER_RE = re.compile(r"(?:^|[_/])(?:layers?|blocks?|h)[_/]?(\d+)")
_DIGIT_RE = re.compile(r"/(\d+)(?:/|$)")


def static_node_features(node: Node) -> np.ndarray:
    """Features 0–8: pure functions of the node itself (no history).

    Cached per node key by `LGA.prepare` across saves — a reused node
    (same key, unchanged shape/size/children) has bit-identical static
    features, so only the EMA column (feature 9) needs refreshing.
    """
    f = np.zeros((N_FEATURES,), dtype=np.float64)
    f[0] = np.log2(node.size + 1.0)
    f[1] = float(len(node.path))
    if node.shape:
        f[2] = np.log2(float(node.shape[0]) + 1.0)
    f[3] = float(len(node.children))
    f[4] = 1.0 if node.kind == CHUNK else 0.0
    f[5] = 1.0 if node.kind == SCALAR else 0.0
    dt = node.dtype or ""
    f[6] = 0.0 if _FLOAT_RE.search(dt) else (1.0 if _INT_RE.search(dt) else 2.0)
    p = "/".join(node.path)
    if p.startswith("params"):
        f[7] = 0.0
    elif p.startswith(("opt_state", "opt", "mu", "nu")) or "/mu/" in p or "/nu/" in p:
        f[7] = 1.0
    elif "cache" in p or "kv" in p:
        f[7] = 2.0
    else:
        f[7] = 3.0
    m = _LAYER_RE.search(p) or _DIGIT_RE.search(p)
    if m:
        f[8] = min(1.0, int(m.group(1)) / 128.0)
    return f


class VolatilityModel:
    """λ(u) ∈ [0, 1] per node."""

    def predict(self, feats: np.ndarray) -> np.ndarray:  # (N, F) -> (N,)
        raise NotImplementedError


class ConstantVolatility(VolatilityModel):
    """λ≡c.  c=0 → LGA-0, c=1 → LGA-1 (paper §8.7 ablations)."""

    def __init__(self, c: float):
        self.c = float(c)

    def predict(self, feats: np.ndarray) -> np.ndarray:
        return np.full((feats.shape[0],), self.c, dtype=np.float64)


class PriorVolatility(VolatilityModel):
    """Heuristic prior before any history: counters always change; payloads
    default to their flip-rate EMA feature (0.5 when unknown)."""

    def predict(self, feats: np.ndarray) -> np.ndarray:
        lam = feats[:, 9].copy()
        lam[feats[:, 5] > 0.5] = 1.0          # scalars/counters
        lam[(feats[:, 4] < 0.5) & (feats[:, 5] < 0.5)] = 0.05  # containers/meta
        return np.clip(lam, 0.0, 1.0)


class FlipTracker:
    """Historical per-chunk flip EMA (feature 9), which speculation
    (`predicted`) and the podding policy read.

    The EMA lives in an array aligned with the active keys of the last
    `observe` and is mirrored into `ema`; the array is re-laid only when
    the active keys change.
    """

    def __init__(self, beta: float = 0.3):
        self.beta = beta
        self.ema: Dict[str, float] = {}
        self._keys: List[str] = []
        self._index: Dict[str, int] = {}
        self._ema = np.zeros((0,), dtype=np.float64)
        #: leaf key -> (its node at the last `chunk_keys`, its chunk keys)
        self._leaves: Dict[str, Tuple[Node, List[str]]] = {}

    def chunk_keys(self, graph: ObjectGraph, leaves: Iterable[str]
                   ) -> List[str]:
        """Keys of the chunks of the leaves named in `leaves`.

        Nodes are never mutated and an unchanged leaf keeps its node and
        its chunks' nodes across incremental builds, so a leaf whose node
        is the one seen last time reuses its key list."""
        keys: List[str] = []
        seen: Dict[str, Tuple[Node, List[str]]] = {}
        for k in sorted(leaves):
            node = graph.nodes.get(graph.by_key.get(k))
            if node is None or node.kind != LEAF:
                continue
            hit = self._leaves.get(k)
            if hit is None or hit[0] is not node:
                hit = (node, [graph.nodes[c].key for c in node.children])
            seen[k] = hit
            keys += hit[1]
        self._leaves = seen
        return keys

    def observe(self, graph: ObjectGraph, dirty_keys: Iterable[str],
                active_keys: Optional[Iterable[str]] = None) -> int:
        """Update the EMA of every active key (every chunk of `graph`
        when `active_keys` is None): a key in `dirty_keys` flipped.
        Returns the number of keys updated."""
        if active_keys is None:
            active_keys = [n.key for n in graph.chunk_nodes()]
        elif not isinstance(active_keys, list):
            active_keys = list(active_keys)
        if active_keys != self._keys:
            self._relayout(active_keys)
        keys, index = self._keys, self._index
        flipped = np.zeros((len(keys),), dtype=np.float64)
        flipped[[i for i in map(index.get, dirty_keys) if i is not None]] = 1.0
        # the reference's per-key (1 - beta) * prev + beta * flipped: the
        # same IEEE operations in the same order, so the same bits
        ema = (1 - self.beta) * self._ema + self.beta * flipped
        self._ema = ema
        self.ema.update(zip(keys, ema.tolist()))
        return len(keys)

    def _relayout(self, active_keys: List[str]) -> None:
        """Align the array with new active keys; each key's EMA comes
        from `ema` (0.5 for a key never observed)."""
        keys = list(dict.fromkeys(active_keys))
        self._keys = keys
        self._index = dict(zip(keys, range(len(keys))))
        self._ema = np.fromiter(map(self.ema.get, keys, repeat(0.5)),
                                dtype=np.float64, count=len(keys))

    def predicted(self, threshold: float = 0.25) -> Set[str]:
        """Chunk keys whose flip EMA exceeds `threshold` — the speculative
        dirty set the fused save compacts into the digest fetch.  Keys
        never observed are absent (no EMA → no prediction)."""
        return {k for k, v in self.ema.items() if v > threshold}
