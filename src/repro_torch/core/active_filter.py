"""Active variable filter (paper §4.3, Thm 4.1).

A leaf is *active* for a save iff it may have changed since the previous
save.  Three evidence sources compose (intersection of "may have changed"
over-approximations):

  1. ASCC (ascc.py): leaves the step function provably returns unchanged
     are inactive — sound by construction.
  2. A *touch report* from the step itself (e.g. per-expert token counters
     from the MoE router, frozen-parameter masks): subtrees the window
     provably did not touch are inactive.
  3. Thm 4.1 expansion: starting from the accessed variables, expand over
     the *prior PodGraph* — any active leaf must live in a pod connected to
     an accessed variable's pod.

The filter returns the set of active leaf paths; the change detector skips
fingerprinting everything else (the paper's biggest save-time lever, §8.8).
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, Optional, Set

from .graph import LEAF, ObjectGraph, path_str
from .podding import PodAssignment


def leaves_under(graph: ObjectGraph, prefixes: Iterable[str]) -> Set[str]:
    """All leaf paths under any of the given path prefixes.

    Answered per prefix with bisect range scans over the graph's sorted
    LEAF-only key list (O(log L + leaf matches)) instead of scanning
    every leaf for every prefix — and without materializing chunk keys,
    which outnumber leaves on large chunked arrays.  A key lies in
    [pre + "/", pre + "0") iff it starts with "pre/" ("0" = chr(ord("/")
    + 1)), so the ranges need no post-filtering.
    """
    out: Set[str] = set()
    ks = graph.sorted_leaf_keys()
    for pre in prefixes:
        i = bisect.bisect_left(ks, pre)
        if i < len(ks) and ks[i] == pre:
            out.add(pre)
        lo = bisect.bisect_left(ks, pre + "/")
        hi = bisect.bisect_left(ks, pre + "0")
        out.update(ks[lo:hi])
    return out


def expand_active_pods(prior: PodAssignment, graph: ObjectGraph,
                       accessed_vars: Iterable[str]) -> Set[int]:
    """Thm 4.1: pods connected (undirected, transitively) to any accessed
    variable's pod on the prior PodGraph."""
    adj = prior.pod_graph_neighbors()
    frontier: list = []
    seen: Set[int] = set()
    for var in accessed_vars:
        nid = graph.variables.get(var)
        if nid is None:
            continue
        pid = prior.node_pod.get(nid)
        if pid is None:
            continue
        if pid not in seen:
            seen.add(pid)
            frontier.append(pid)
    while frontier:
        pid = frontier.pop()
        for nxt in adj.get(pid, ()):  # connected pods
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    return seen


class ActiveVariableFilter:
    def __init__(self) -> None:
        self.last_stats: Dict[str, int] = {}

    def active_leaves(
        self,
        graph: ObjectGraph,
        *,
        readonly_paths: Optional[Set[str]] = None,
        touched_prefixes: Optional[Iterable[str]] = None,
        prior_pods: Optional[PodAssignment] = None,
        prior_graph: Optional[ObjectGraph] = None,
        accessed_vars: Optional[Iterable[str]] = None,
    ) -> Set[str]:
        all_leaves = {n.key for n in graph.leaf_nodes()}
        active = set(all_leaves)

        if readonly_paths:
            active -= set(readonly_paths)

        if touched_prefixes is not None:
            active &= leaves_under(graph, touched_prefixes)

        if prior_pods is not None and accessed_vars is not None:
            ref_graph = prior_graph or graph
            pods = expand_active_pods(prior_pods, ref_graph, accessed_vars)
            in_pods: Set[str] = set()
            for node in ref_graph.leaf_nodes():
                if prior_pods.node_pod.get(node.node_id) in pods:
                    in_pods.add(node.key)
            # leaves new since the prior graph are always active
            new_leaves = all_leaves - {n.key for n in ref_graph.leaf_nodes()}
            active &= (in_pods | new_leaves)

        self.last_stats = {
            "total_leaves": len(all_leaves),
            "active_leaves": len(active),
        }
        return active
