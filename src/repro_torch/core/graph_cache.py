"""Incremental ObjectGraph construction (cached trie re-walk).

`build_graph` rebuilds the whole trie — every container, leaf, and chunk
node — from scratch on every save, even though training state almost never
changes *shape* between checkpoints.  `GraphCache` keeps the previous
save's graph and re-walks only what changed:

  * the flatten pass (cheap: O(containers + leaves)) always runs — it is
    the only way to observe Python-side structure — but node construction
    is skipped wherever the cached trie already matches;
  * a leaf whose (shape, dtype) are unchanged reuses its LEAF node *and*
    every CHUNK node beneath it wholesale (the dominant node count for
    large arrays), keeping node ids and keys stable;
  * a scalar whose value changed keeps its node id (non-structural: only
    the pod digest is affected) but gets a fresh Node carrying the new
    value, so the previous graph — still referenced by the AVF — is never
    mutated;
  * containers are re-created only when their child id list changed, which
    makes structural change propagate to the root automatically: any
    insert/remove/re-shape gives some ancestor chain fresh children.

Stability contract (what delta re-podding relies on):

  * same key + same kind  ⇒  same node id across builds;
  * zero structural changes  ⇒  the new graph is node-for-node identical
    to the previous one (ids, children order, DFS order), so the previous
    `PodAssignment` — keyed by node id — applies verbatim and every memo
    local is preserved;
  * the incremental graph is *structurally* indistinguishable from a
    from-scratch `build_graph` of the same state (keys, kinds, children
    order, chunk grids, alias targets, scalar values) — node ids may
    differ from the from-scratch numbering, but node ids never reach
    manifests or pod bytes, so the persisted artifacts are bit-identical.

Shared Node objects between the cached and the new graph are safe because
nodes are never mutated after construction — a changed node is replaced,
not edited.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Set, Tuple

from .graph import (ALIAS, CONTAINER, LEAF, SCALAR, STRUCT_SIZE, Node,
                    ObjectGraph, Path, _flatten_with_paths, _is_arraylike,
                    build_graph, build_leaf_nodes, dtype_name, path_str)


def _scalar_sig(v: Any) -> Tuple[str, str]:
    """Value signature for scalar change detection: (type name, repr).

    Captured at *build time* and compared against the previous build's
    snapshot — never against the stored object, because an in-place
    mutation of a mutable leaf (bytearray cursor, list-valued counter)
    leaves the cached reference equal to itself.  repr is the right
    discriminator: it is exactly what `pod_structural_digest` hashes for
    SCALAR nodes, so the incremental path flags a change iff the
    from-scratch oracle's pod digest would move.
    """
    try:
        return (type(v).__name__, repr(v))
    except Exception:
        return (type(v).__name__, f"<unreprable@{id(v)}>")


@dataclasses.dataclass
class IncrementalBuildInfo:
    """What the cached re-walk did, for save stats and re-podding."""

    from_scratch: bool
    n_nodes_reused: int = 0
    n_nodes_rebuilt: int = 0
    #: any container/leaf/alias created, removed, or re-shaped — exactly
    #: the condition under which the previous PodAssignment cannot be
    #: reused verbatim.
    structural_change: bool = False
    #: scalar keys whose value changed (non-structural; dirties pod digests)
    scalar_changed_keys: List[str] = dataclasses.field(default_factory=list)
    #: every key whose Node object was newly constructed this build —
    #: feeds LGA's incremental feature preparation.
    rebuilt_keys: Set[str] = dataclasses.field(default_factory=set)


class GraphCache:
    """Cross-save trie cache: `build(state)` returns (graph, build info)."""

    def __init__(self, *, chunk_bytes: int = 1 << 22) -> None:
        self.chunk_bytes = chunk_bytes
        self.graph: Optional[ObjectGraph] = None
        self._next_id = 0
        #: scalar key -> build-time value signature of the previous build
        self._scalar_sigs: Dict[str, Tuple[str, str]] = {}

    # ------------------------------------------------------------------
    def build(self, state: Any) -> Tuple[ObjectGraph, IncrementalBuildInfo]:
        if self.graph is None:
            g = build_graph(state, chunk_bytes=self.chunk_bytes)
            self.graph = g
            self._next_id = (max(g.nodes) + 1) if g.nodes else 0
            self._scalar_sigs = {n.key: _scalar_sig(n.value)
                                 for n in g.nodes.values()
                                 if n.kind == SCALAR}
            return g, IncrementalBuildInfo(
                from_scratch=True, n_nodes_rebuilt=g.n_nodes(),
                structural_change=True,
                rebuilt_keys=set(g.by_key))
        g, info = self._build_incremental(state)
        self.graph = g
        return g, info

    def invalidate(self) -> None:
        self.graph = None
        self._scalar_sigs = {}

    def adopt(self, graph: ObjectGraph) -> None:
        """Install an externally built graph as the cache baseline.

        Used by delta-aware checkout: the graph of the restored state
        becomes the previous build, so the first `save()` after a checkout
        re-walks nothing and — with an unchanged structure — reuses the
        checked-out `PodAssignment` verbatim instead of falling back to a
        from-scratch build.
        """
        self.graph = graph
        self._next_id = (max(graph.nodes) + 1) if graph.nodes else 0
        self._scalar_sigs = {n.key: _scalar_sig(n.value)
                             for n in graph.nodes.values()
                             if n.kind == SCALAR}

    # ------------------------------------------------------------------
    def _fresh_id(self) -> int:
        nid = self._next_id
        self._next_id += 1
        return nid

    def _build_incremental(self, state: Any
                           ) -> Tuple[ObjectGraph, IncrementalBuildInfo]:
        prev = self.graph
        assert prev is not None
        prev_nodes = prev.nodes
        prev_by_key = prev.by_key

        nodes: Dict[int, Node] = {}
        by_key: Dict[str, int] = {}
        arrays: Dict[str, Any] = {}
        info = IncrementalBuildInfo(from_scratch=False)
        scalar_sigs = self._scalar_sigs
        new_sigs: Dict[str, Tuple[str, str]] = {}

        leaves = _flatten_with_paths(state)

        # canonical alias assignment: first occurrence in walk order, same
        # rule as build_graph, computed up front so a leaf knows whether it
        # is canonical before its node is built.
        seen_objects: Dict[int, Path] = {}
        canon_of: Dict[Path, Path] = {}
        for path, leaf in leaves:
            if leaf is not None and _is_arraylike(leaf):
                oid = id(leaf)
                if oid in seen_objects:
                    canon_of[path] = seen_objects[oid]
                else:
                    seen_objects[oid] = path

        def register(node: Node, reused: bool) -> None:
            nodes[node.node_id] = node
            by_key[node.key] = node.node_id
            if reused:
                info.n_nodes_reused += 1
            else:
                info.n_nodes_rebuilt += 1
                info.rebuilt_keys.add(node.key)

        def alloc_node(**kw: Any) -> Node:
            """Fresh-id allocator handed to the shared leaf/chunk builder."""
            node = Node(node_id=self._fresh_id(), **kw)
            register(node, reused=False)
            return node

        # container children accumulate as the leaf walk proceeds; the
        # Node objects themselves are finalized afterwards, once their
        # child lists are complete.
        child_ids: Dict[Path, List[int]] = {(): []}
        container_order: List[Path] = [()]
        container_ids: Dict[Path, int] = {}

        def container_id(path: Path) -> int:
            nid = container_ids.get(path)
            if nid is None:
                pv = prev_by_key.get(path_str(path))
                if pv is not None and prev_nodes[pv].kind == CONTAINER:
                    nid = pv
                else:
                    nid = self._fresh_id()
                container_ids[path] = nid
            return nid

        def ensure_container(path: Path) -> List[int]:
            kids = child_ids.get(path)
            if kids is None:
                parent = ensure_container(path[:-1])
                kids = child_ids[path] = []
                container_order.append(path)
                parent.append(container_id(path))
            return kids

        for path, leaf in leaves:
            parent = ensure_container(path[:-1]) if path else child_ids[()]
            key = path_str(path)
            pv_id = prev_by_key.get(key)
            pv = prev_nodes.get(pv_id) if pv_id is not None else None

            if leaf is None or not _is_arraylike(leaf):
                # SCALAR (includes None — matches build_graph).  Change
                # detection compares build-time signatures, not the cached
                # object: in-place mutation of a mutable leaf would make
                # the stored reference compare equal to itself.
                sig = _scalar_sig(leaf)
                if pv is not None and pv.kind == SCALAR:
                    if scalar_sigs.get(key) == sig:
                        node = pv
                        register(node, reused=True)
                    else:
                        node = Node(node_id=pv.node_id, path=path,
                                    kind=SCALAR, size=STRUCT_SIZE, value=leaf)
                        info.scalar_changed_keys.append(key)
                        register(node, reused=False)
                else:
                    node = Node(node_id=self._fresh_id(), path=path,
                                kind=SCALAR, size=STRUCT_SIZE, value=leaf)
                    info.structural_change = True
                    register(node, reused=False)
                new_sigs[key] = sig
                parent.append(node.node_id)
                continue

            canon = canon_of.get(path)
            if canon is not None:
                # ALIAS of the canonical occurrence
                if pv is not None and pv.kind == ALIAS and pv.alias_of == canon:
                    node = pv
                    register(node, reused=True)
                else:
                    nid = pv.node_id if pv is not None and pv.kind == ALIAS \
                        else self._fresh_id()
                    node = Node(node_id=nid, path=path, kind=ALIAS,
                                size=STRUCT_SIZE, alias_of=canon)
                    info.structural_change = True
                    register(node, reused=False)
                parent.append(node.node_id)
                continue

            # canonical array LEAF
            shape = tuple(int(d) for d in leaf.shape)
            dtype = dtype_name(leaf.dtype)
            if (pv is not None and pv.kind == LEAF
                    and pv.shape == shape and pv.dtype == dtype):
                # unchanged grid: splice the leaf and all its chunks
                register(pv, reused=True)
                for cid in pv.children:
                    register(prev_nodes[cid], reused=True)
                arrays[key] = leaf
                parent.append(pv.node_id)
                continue

            info.structural_change = True
            lnode = build_leaf_nodes(path, leaf, self.chunk_bytes, alloc_node)
            parent.append(lnode.node_id)
            arrays[key] = leaf

        # finalize containers (in first-touch order, matching build_graph's
        # creation order); a container is reused only when its children
        # came out identical.
        for path in container_order:
            nid = container_id(path)
            kids = child_ids[path]
            pv_id = prev_by_key.get(path_str(path))
            pv = prev_nodes.get(pv_id) if pv_id is not None else None
            if (pv is not None and pv.kind == CONTAINER
                    and pv.node_id == nid and pv.children == kids):
                register(pv, reused=True)
            else:
                node = Node(node_id=nid, path=path, kind=CONTAINER,
                            size=STRUCT_SIZE, children=kids)
                if pv is None or pv.kind != CONTAINER:
                    info.structural_change = True
                elif pv.children != kids:
                    info.structural_change = True
                register(node, reused=False)

        # removed subtrees leave no trace in `nodes`; they always surface
        # as a changed ancestor child list, but assert the invariant for
        # the pure-removal edge case where nothing else was rebuilt.
        if not info.structural_change and len(nodes) != prev.n_nodes():
            info.structural_change = True

        self._scalar_sigs = new_sigs
        root_id = container_ids[()]
        variables: Dict[str, int] = {}
        for cid in child_ids[()]:
            n = nodes[cid]
            if len(n.path) == 1:
                variables[n.path[0]] = cid
        return ObjectGraph(nodes=nodes, root_id=root_id, by_key=by_key,
                           variables=variables, arrays=arrays), info
