"""Podding decisions (paper §4.1 actions, §5 LGA = Algorithm 1).

A podding policy maps (object, current pod state, pod depth) to one of three
actions.  LGA compares the marginal expected costs

    ΔL_bundle = s(u_p)·λ(u) + s(u)·(λ(u_p) + λ(u))     (Eq. 4)
    ΔL_split  = c_pod + s(u)·λ(u)                       (Eq. 5)

and bundles iff ΔL_bundle < ΔL_split; otherwise split-continue while the
pod depth is below MAX_POD_DEPTH, else split-final.  Decisions are memoized
per node key, which yields podding stability Sim(A_i, A_{i+1}) = 1 (§7.3).

Also provided: the paper's §8.7 alternatives — BundleAll, SplitAll, Random,
the type-based heuristic TbH (Appendix A.1), and LGA-0/LGA-1 via
ConstantVolatility.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set

import numpy as np

from .graph import ALIAS, CHUNK, CONTAINER, LEAF, SCALAR, Node, ObjectGraph
from .volatility import (N_FEATURES, ConstantVolatility, PriorVolatility,
                         VolatilityModel, static_node_features)

BUNDLE = "bundle"
SPLIT_CONTINUE = "split-continue"
SPLIT_FINAL = "split-final"

DEFAULT_C_POD = 1200.0       # paper §7.5
DEFAULT_MAX_POD_DEPTH = 3    # paper §7.5


@dataclasses.dataclass
class PodState:
    """Running size/volatility of the pod currently being built."""

    pod_id: int
    depth: int
    size: float = 0.0
    lam: float = 0.0

    def admit(self, s: float, lam: float) -> None:
        self.size += s
        self.lam += lam  # Poisson composability (§5.2)


class PoddingPolicy:
    name = "base"

    def prepare(self, graph: ObjectGraph,
                flip_ema: Optional[Dict[str, float]] = None,
                changed_keys: Optional[Set[str]] = None) -> None:
        """Called once per podding pass; precompute per-node λ etc.

        `changed_keys` (incremental graph builds only) names the keys whose
        nodes were rebuilt since the previous save; policies may trust
        per-key caches for everything else."""

    def lam(self, node: Node) -> float:
        return 0.0

    def decide(self, node: Node, pod: PodState) -> str:
        raise NotImplementedError


class LGA(PoddingPolicy):
    """Algorithm 1 (learned greedy), with decision memoization."""

    name = "lga"

    def __init__(self, volatility: Optional[VolatilityModel] = None,
                 c_pod: float = DEFAULT_C_POD,
                 max_pod_depth: int = DEFAULT_MAX_POD_DEPTH):
        self.volatility = volatility or PriorVolatility()
        self.c_pod = float(c_pod)
        self.max_pod_depth = int(max_pod_depth)
        self._lam: Dict[str, float] = {}
        self._memo: Dict[str, str] = {}   # node key -> action (§7.3 stability)
        self._feat_static: Dict[str, np.ndarray] = {}  # key -> features 0–8

    def prepare(self, graph: ObjectGraph,
                flip_ema: Optional[Dict[str, float]] = None,
                changed_keys: Optional[Set[str]] = None) -> None:
        """Per-node λ for this save.

        The static feature rows (0–8) are cached per key across saves;
        when `changed_keys` is provided (incremental graph build) only the
        rebuilt keys recompute their row — the Python-loop feature
        extraction is the dominant podding-prep cost on big graphs.  The
        EMA column and the model prediction always rerun (vectorized)
        because mutation history moves every save.
        """
        cache = self._feat_static
        trust_cache = changed_keys is not None
        keys = []
        rows = []
        for n in graph.nodes.values():
            k = n.key
            row = None
            if trust_cache and k not in changed_keys:
                row = cache.get(k)
            if row is None:
                row = static_node_features(n)
                cache[k] = row
            keys.append(k)
            rows.append(row)
        X = (np.stack(rows) if rows
             else np.zeros((0, N_FEATURES), dtype=np.float64))
        if flip_ema is not None:
            X[:, 9] = np.fromiter((flip_ema.get(k, 0.5) for k in keys),
                                  dtype=np.float64, count=len(keys))
        else:
            X[:, 9] = 0.5
        lam = self.volatility.predict(X)
        self._lam = {k: float(l) for k, l in zip(keys, lam)}
        if len(cache) > 2 * len(keys) + 64:   # bound growth over dead keys
            live = set(keys)
            for k in list(cache):
                if k not in live:
                    del cache[k]

    def lam(self, node: Node) -> float:
        return self._lam.get(node.key, 0.5)

    def decide(self, node: Node, pod: PodState) -> str:
        memo = self._memo.get(node.key)
        if memo is not None:
            if memo == SPLIT_CONTINUE and pod.depth >= self.max_pod_depth:
                return SPLIT_FINAL
            return memo
        s_u = float(node.size)
        lam_u = self.lam(node)
        d_bundle = pod.size * lam_u + s_u * (pod.lam + lam_u)   # Eq. 4
        d_split = self.c_pod + s_u * lam_u                      # Eq. 5
        if d_bundle < d_split:
            action = BUNDLE
        elif pod.depth < self.max_pod_depth:
            action = SPLIT_CONTINUE
        else:
            action = SPLIT_FINAL
        self._memo[node.key] = action
        return action


def lga0(**kw) -> LGA:
    p = LGA(volatility=ConstantVolatility(0.0), **kw)
    p.name = "lga-0"
    return p


def lga1(**kw) -> LGA:
    p = LGA(volatility=ConstantVolatility(1.0), **kw)
    p.name = "lga-1"
    return p


class BundleAll(PoddingPolicy):
    name = "bundle-all"

    def decide(self, node: Node, pod: PodState) -> str:
        return BUNDLE


class SplitAll(PoddingPolicy):
    name = "split-all"

    def decide(self, node: Node, pod: PodState) -> str:
        return SPLIT_CONTINUE if pod.depth < 1 << 30 else SPLIT_FINAL


class RandomPolicy(PoddingPolicy):
    """Uniformly random action (paper §8.7), memoized for determinism."""

    name = "random"

    def __init__(self, seed: int = 0, max_pod_depth: int = DEFAULT_MAX_POD_DEPTH):
        self.rng = np.random.default_rng(seed)
        self.max_pod_depth = max_pod_depth
        self._memo: Dict[str, str] = {}

    def decide(self, node: Node, pod: PodState) -> str:
        a = self._memo.get(node.key)
        if a is None:
            a = [BUNDLE, SPLIT_CONTINUE, SPLIT_FINAL][int(self.rng.integers(0, 3))]
            self._memo[node.key] = a
        if a == SPLIT_CONTINUE and pod.depth >= self.max_pod_depth:
            return SPLIT_FINAL
        return a


class TbH(PoddingPolicy):
    """Type-based heuristic (paper Appendix A.1), adapted to state graphs:

    * payload chunks of large "application" arrays → split-final
      (coherent groups that mutate together),
    * containers / leaf-meta (compositional types) → split-continue,
    * scalars & tiny arrays (immutable-ish) → bundle.
    """

    name = "tbh"

    def __init__(self, small_bytes: int = 4096,
                 max_pod_depth: int = DEFAULT_MAX_POD_DEPTH):
        self.small_bytes = small_bytes
        self.max_pod_depth = max_pod_depth

    def decide(self, node: Node, pod: PodState) -> str:
        if node.kind in (SCALAR, ALIAS):
            return BUNDLE
        if node.kind == CHUNK:
            return BUNDLE if node.size <= self.small_bytes else SPLIT_FINAL
        # containers and leaf metadata
        if pod.depth < self.max_pod_depth:
            return SPLIT_CONTINUE
        return SPLIT_FINAL


def expected_cost(pod_sizes_lams, c_pod: float = DEFAULT_C_POD) -> float:
    """L(U_p; G) = Σ [c_pod + s(u_p)·λ(u_p)]  (Eq. 3, with composed λ)."""
    return sum(c_pod + s * l for s, l in pod_sizes_lams)
