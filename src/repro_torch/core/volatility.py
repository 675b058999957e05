"""Composable volatility model (paper §5.2).

Object mutations are modeled as Poisson events with rate λ(u) <= 1 per
step-window; pod volatility composes by summation λ(u_p) = Σ λ(u).

The paper trains LightGBM on lightweight, type-agnostic features (immediate
size, length, __dict__ length).  LightGBM is unavailable offline, so we ship
a small gradient-boosted-stumps regressor in pure numpy with the same
contract, plus the paper's ablation models (λ≡0 → LGA-0, λ≡1 → LGA-1) and a
heuristic prior used before any mutation history exists.

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
from typing import Dict, Iterable, List, Optional, Set

import numpy as np

from .graph import CHUNK, CONTAINER, LEAF, SCALAR, Node, ObjectGraph

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


def node_features(node: Node, graph: ObjectGraph,
                  flip_ema: Optional[Dict[str, float]] = None) -> np.ndarray:
    f = static_node_features(node)
    f[9] = flip_ema.get(node.key, 0.5) if flip_ema is not None else 0.5
    return f


def graph_features(graph: ObjectGraph,
                   flip_ema: Optional[Dict[str, float]] = None) -> Dict[str, np.ndarray]:
    return {n.key: node_features(n, graph, flip_ema) for n in graph.nodes.values()}


class VolatilityModel:
    """λ(u) ∈ [0, 1] per node."""

    def predict(self, feats: np.ndarray) -> np.ndarray:  # (N, F) -> (N,)
        raise NotImplementedError

    def predict_one(self, f: np.ndarray) -> float:
        return float(self.predict(f[None, :])[0])


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


class _Stump:
    __slots__ = ("feature", "threshold", "left", "right")

    def __init__(self, feature: int, threshold: float, left: float, right: float):
        self.feature, self.threshold = feature, threshold
        self.left, self.right = left, right

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.where(X[:, self.feature] <= self.threshold, self.left, self.right)


class GBMVolatility(VolatilityModel):
    """Gradient-boosted depth-1 trees with logistic loss (LightGBM stand-in).

    Fit on (features, mutated?) samples bootstrapped from the change
    detector, exactly the paper's §7.5 procedure.
    """

    def __init__(self, n_estimators: int = 60, learning_rate: float = 0.2,
                 n_thresholds: int = 16):
        self.n_estimators = n_estimators
        self.lr = learning_rate
        self.n_thresholds = n_thresholds
        self.base = 0.0
        self.stumps: List[_Stump] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBMVolatility":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        pbar = float(np.clip(y.mean(), 1e-4, 1 - 1e-4))
        self.base = float(np.log(pbar / (1 - pbar)))
        raw = np.full(y.shape, self.base)
        self.stumps = []
        for _ in range(self.n_estimators):
            p = 1.0 / (1.0 + np.exp(-raw))
            grad = y - p                      # negative gradient of logloss
            stump = self._fit_stump(X, grad)
            if stump is None:
                break
            self.stumps.append(stump)
            raw = raw + self.lr * stump.predict(X)
        return self

    def _fit_stump(self, X: np.ndarray, g: np.ndarray) -> Optional[_Stump]:
        best = None
        best_gain = 1e-12
        n, F = X.shape
        for j in range(F):
            col = X[:, j]
            qs = np.quantile(col, np.linspace(0.05, 0.95, self.n_thresholds))
            for t in np.unique(qs):
                mask = col <= t
                nl = int(mask.sum())
                if nl == 0 or nl == n:
                    continue
                gl = g[mask].sum()
                gr = g.sum() - gl
                gain = gl * gl / nl + gr * gr / (n - nl)
                if gain > best_gain:
                    best_gain = gain
                    best = _Stump(j, float(t), float(gl / nl), float(gr / (n - nl)))
        return best

    def predict(self, feats: np.ndarray) -> np.ndarray:
        X = np.asarray(feats, dtype=np.float64)
        raw = np.full((X.shape[0],), self.base)
        for s in self.stumps:
            raw = raw + self.lr * s.predict(X)
        return np.clip(1.0 / (1.0 + np.exp(-raw)), 0.0, 1.0)


class FlipTracker:
    """Historical per-node mutation EMA (feature 9) + training-sample buffer."""

    def __init__(self, beta: float = 0.3):
        self.beta = beta
        self.ema: Dict[str, float] = {}
        self.samples_X: List[np.ndarray] = []
        self.samples_y: List[float] = []

    def observe(self, graph: ObjectGraph, dirty_keys: Iterable[str],
                active_keys: Optional[Iterable[str]] = None,
                collect: bool = True) -> None:
        dirty = set(dirty_keys)
        keys = set(active_keys) if active_keys is not None else {
            n.key for n in graph.nodes.values() if n.kind == CHUNK}
        for key in keys:
            flipped = 1.0 if key in dirty else 0.0
            prev = self.ema.get(key, 0.5)
            self.ema[key] = (1 - self.beta) * prev + self.beta * flipped
            if collect and key in graph.by_key:
                node = graph.nodes[graph.by_key[key]]
                self.samples_X.append(node_features(node, graph, self.ema))
                self.samples_y.append(flipped)

    def predicted(self, threshold: float = 0.25) -> Set[str]:
        """Chunk keys whose flip EMA exceeds `threshold` — the speculative
        dirty set the fused save compacts into the digest fetch.  Keys
        never observed are absent (no EMA → no prediction)."""
        return {k for k, v in self.ema.items() if v > threshold}

    def fit_gbm(self, **kw) -> GBMVolatility:
        model = GBMVolatility(**kw)
        if self.samples_X:
            model.fit(np.stack(self.samples_X), np.asarray(self.samples_y))
        return model
