"""Podding / unpodding engine (paper §4.1).

Podding walks the ObjectGraph depth-first (serialization order) and, for
each node, consults the podding policy: *bundle* into the current pod,
*split-continue* into a fresh pod (descendants decided recursively), or
*split-final* into a fresh pod that swallows the whole subtree.

Each pod serializes to deterministic bytes (msgpack): an ordered list of
node entries whose child references are **virtual memo IDs** — local
natural numbers within the pod, `2^31 + global` across pods (see memo.py).
Chunk entries carry the raw array bytes.

Unpodding reverses the process: deserialize entries, resolve virtual memo
IDs through the page tables, reassemble row-block chunks into arrays, and
restore shared references as true aliases (same object), which is what
makes Ser(Unpod(Pod(G))) = Ser(G) (Thm 7.1) hold.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import msgpack
import numpy as np
import torch

from ..kernels.ops import fetch_to_host, is_host_array
from .graph import (ALIAS, CHUNK, CONTAINER, LEAF, SCALAR, Node, ObjectGraph,
                    chunk_slice, path_str, torch_dtype)
from .lga import BUNDLE, SPLIT_CONTINUE, SPLIT_FINAL, PodState, PoddingPolicy
from .memo import CROSS_POD_OFFSET, GlobalMemoSpace


@dataclasses.dataclass
class Pod:
    pod_id: int
    depth: int
    node_ids: List[int] = dataclasses.field(default_factory=list)
    size: float = 0.0
    lam: float = 0.0


@dataclasses.dataclass
class PodAssignment:
    pods: Dict[int, Pod]
    node_pod: Dict[int, int]              # node_id -> pod_id
    node_local: Dict[int, int]            # node_id -> local memo id in its pod
    memo: GlobalMemoSpace
    root_pod: int
    edges: Set[Tuple[int, int]]           # PodGraph E_p (directed)

    def pod_of_key(self, graph: ObjectGraph, key: str) -> int:
        return self.node_pod[graph.by_key[key]]

    def pod_graph_neighbors(self) -> Dict[int, Set[int]]:
        """Undirected adjacency of the PodGraph (used by Thm 4.1 expansion)."""
        adj: Dict[int, Set[int]] = {p: set() for p in self.pods}
        for a, b in self.edges:
            adj[a].add(b)
            adj[b].add(a)
        return adj


def pod_graph(graph: ObjectGraph, policy: PoddingPolicy,
              flip_ema: Optional[Dict[str, float]] = None,
              memo_page_size: int = 1024,
              changed_keys: Optional[Set[str]] = None) -> PodAssignment:
    """Run podding over the graph with the given policy.

    Delta re-podding (§7.3 in practice): because policies memoize their
    decision per node *key*, a walk over a structurally unchanged graph
    reproduces the previous assignment exactly — same pods, same admit
    order, same memo locals, same pages.  `Chipmink` exploits this by
    reusing the previous `PodAssignment` verbatim when the incremental
    graph build reports zero structural changes (every memo local is
    preserved without re-walking anything).  When structure *did* change,
    the full walk reruns here, but `changed_keys` (the rebuilt node keys
    from the incremental build) lets the policy trust its per-key feature
    caches for the untouched remainder — the walk stays the parity oracle
    either way.
    """
    if changed_keys is None:
        policy.prepare(graph, flip_ema)
    else:
        try:
            policy.prepare(graph, flip_ema, changed_keys=changed_keys)
        except TypeError as e:
            if "changed_keys" not in str(e):
                raise
            # legacy policy with the pre-incremental two-arg signature
            policy.prepare(graph, flip_ema)
    memo = GlobalMemoSpace(page_size=memo_page_size)
    pods: Dict[int, Pod] = {}
    node_pod: Dict[int, int] = {}
    node_local: Dict[int, int] = {}
    edges: Set[Tuple[int, int]] = set()
    next_pod = [0]

    def new_pod(depth: int) -> Pod:
        p = Pod(pod_id=next_pod[0], depth=depth)
        next_pod[0] += 1
        pods[p.pod_id] = p
        return p

    def admit(node: Node, pod: Pod) -> None:
        node_pod[node.node_id] = pod.pod_id
        node_local[node.node_id] = memo.new_local(pod.pod_id)
        pod.node_ids.append(node.node_id)
        pod.size += float(node.size)
        pod.lam += policy.lam(node)

    root = graph.node(graph.root_id)
    root_pod = new_pod(depth=0)
    admit(root, root_pod)

    # iterative DFS: (node_id, current_pod_id, forced) — forced inside a
    # split-final subtree means all descendants bundle without consulting.
    stack: List[Tuple[int, int, bool]] = [
        (cid, root_pod.pod_id, False) for cid in reversed(root.children)]
    while stack:
        nid, cur_pid, forced = stack.pop()
        node = graph.node(nid)
        cur = pods[cur_pid]
        if forced:
            action = BUNDLE
        else:
            action = policy.decide(
                node, PodState(pod_id=cur.pod_id, depth=cur.depth,
                               size=cur.size, lam=cur.lam))
        if action == BUNDLE:
            admit(node, cur)
            child_pid, child_forced = cur.pod_id, forced
        else:
            child = new_pod(depth=cur.depth + 1)
            admit(node, child)
            edges.add((cur.pod_id, child.pod_id))
            child_pid = child.pod_id
            child_forced = action == SPLIT_FINAL
        for cid in reversed(node.children):
            stack.append((cid, child_pid, child_forced))

    # alias edges: a pod referencing a canonical leaf in another pod
    for n in graph.nodes.values():
        if n.kind == ALIAS and n.alias_of is not None:
            canon_id = graph.by_key.get(path_str(n.alias_of))
            if canon_id is not None:
                pa, pb = node_pod[n.node_id], node_pod[canon_id]
                if pa != pb:
                    edges.add((pa, pb))

    return PodAssignment(pods=pods, node_pod=node_pod, node_local=node_local,
                         memo=memo, root_pod=root_pod.pod_id, edges=edges)


# --------------------------------------------------------------------------
# Pod serialization
# --------------------------------------------------------------------------

def _entry_for_node(node: Node, graph: ObjectGraph, asg: PodAssignment,
                    chunk_bytes_of: Callable[[Node], bytes]) -> Dict[str, Any]:
    """Build the serializable entry of one node.  Child references are
    virtual memo IDs."""
    pid = asg.node_pod[node.node_id]
    refs = [
        asg.memo.virtual_for_ref(pid, asg.node_pod[cid], asg.node_local[cid])
        for cid in node.children
    ]
    e: Dict[str, Any] = {
        "k": node.key,
        "t": node.kind,
        "r": refs,
    }
    if node.kind == LEAF:
        e["m"] = {"shape": list(node.shape or ()), "dtype": node.dtype,
                  "rows": node.chunk_rows}
    elif node.kind == CHUNK:
        e["m"] = {"ci": node.chunk_index}
        e["d"] = chunk_bytes_of(node)
    elif node.kind == SCALAR:
        e["m"] = {"v": node.value}
    elif node.kind == ALIAS:
        canon_key = path_str(node.alias_of or ())
        canon_id = graph.by_key[canon_key]
        e["m"] = {"ref": asg.memo.virtual_for_ref(
            pid, asg.node_pod[canon_id], asg.node_local[canon_id]),
            "key": canon_key}
    else:  # container
        e["m"] = {"names": [graph.node(c).path[-1] if graph.node(c).path else ""
                            for c in node.children]}
    return e


def default_chunk_bytes(graph: ObjectGraph) -> Callable[[Node], bytes]:
    """Per-chunk lazy fetch: one blocking device transfer per tensor chunk.
    Kept as the oracle/fallback; the save path uses `batched_chunk_fetch`
    so a whole save costs at most one device sync for payload bytes."""
    def get(node: Node) -> bytes:
        arr = graph.arrays[path_str(node.path)]
        part = chunk_slice(arr, node)
        if is_host_array(arr):
            return np.ascontiguousarray(part).tobytes()
        return fetch_to_host([part])[0].tobytes()
    return get


def batched_chunk_fetch(graph: ObjectGraph, nodes: Sequence[Node]
                        ) -> Tuple[Callable[[Node], bytes], int]:
    """Gather payload bytes of every CHUNK node in `nodes` at once.

    Host (numpy) chunks are sliced directly; all tensor chunk slices are
    fetched with a **single** `fetch_to_host` over the full dirty-chunk
    set — replacing a per-chunk blocking copy in the serializer.  Returns
    (lookup fn for serialize_pod, number of device syncs issued: 0 or 1).
    """
    host_bytes: Dict[str, bytes] = {}
    dev_keys: List[str] = []
    dev_parts: List[Any] = []
    for node in nodes:
        if node.kind != CHUNK:
            continue
        arr = graph.arrays[path_str(node.path)]
        part = chunk_slice(arr, node)
        if is_host_array(arr):
            host_bytes[node.key] = np.ascontiguousarray(part).tobytes()
        else:
            dev_keys.append(node.key)
            dev_parts.append(part)
    n_syncs = 0
    if dev_parts:
        fetched = fetch_to_host(dev_parts)
        n_syncs = 1
        for key, raw in zip(dev_keys, fetched):
            host_bytes[key] = raw.tobytes()

    def get(node: Node) -> bytes:
        return host_bytes[node.key]

    return get, n_syncs


def fused_chunk_fetch(graph: ObjectGraph, nodes: Sequence[Node],
                      payload: Dict[str, bytes]
                      ) -> Tuple[Callable[[Node], bytes], int]:
    """Payload-first gather for the fused single-sync save.

    `payload` holds the byte-exact chunk payloads that were speculatively
    compacted into the digest fetch (`ChangeReport.payload`) — those cost
    nothing here.  Only chunks *missing* from the payload (speculation
    misses, host-numpy chunks) fall through to one corrective
    `batched_chunk_fetch`.  Returns (lookup fn, corrective sync count:
    0 when speculation covered every device chunk, else 1).
    """
    missing = [n for n in nodes if n.kind == CHUNK and n.key not in payload]
    corrective, n_syncs = batched_chunk_fetch(graph, missing)

    def get(node: Node) -> bytes:
        b = payload.get(node.key)
        return b if b is not None else corrective(node)

    return get, n_syncs


def serialize_pod(pod: Pod, graph: ObjectGraph, asg: PodAssignment,
                  chunk_bytes_of: Optional[Callable[[Node], bytes]] = None
                  ) -> bytes:
    chunk_bytes_of = chunk_bytes_of or default_chunk_bytes(graph)
    entries = [
        _entry_for_node(graph.node(nid), graph, asg, chunk_bytes_of)
        for nid in pod.node_ids
    ]
    payload = {"pid": pod.pod_id, "e": entries}
    return msgpack.packb(payload, use_bin_type=True)


def pod_structural_digest(pod: Pod, graph: ObjectGraph, asg: PodAssignment,
                          chunk_digests: Dict[str, bytes]) -> bytes:
    """128-bit pod digest without touching payload bytes: structure +
    device-computed chunk digests.  This is what lets the change detector
    skip the device→host transfer for clean pods entirely."""
    h = hashlib.blake2b(digest_size=16)
    for nid in pod.node_ids:
        node = graph.node(nid)
        h.update(node.key.encode())
        h.update(node.kind.encode())
        if node.kind == CHUNK:
            h.update(chunk_digests[node.key])
        elif node.kind == SCALAR:
            h.update(repr(node.value).encode())
        elif node.kind == LEAF:
            h.update(repr((node.shape, node.dtype, node.chunk_rows)).encode())
        elif node.kind == ALIAS:
            h.update(path_str(node.alias_of or ()).encode())
        pid = asg.node_pod[nid]
        for cid in node.children:
            v = asg.memo.virtual_for_ref(pid, asg.node_pod[cid],
                                         asg.node_local[cid])
            h.update(v.to_bytes(8, "little"))
    return h.digest()


def open_manifest(manifest: Dict[str, Any]
                  ) -> Tuple[GlobalMemoSpace, Dict[int, str]]:
    """Decode a manifest's pod table: (memo space from the persisted page
    tables, {pod_id: digest_hex}).  Single source of truth for the read
    path — `Chipmink.load` and delta-aware checkout must agree on it."""
    pages = {int(pid): meta["pages"]
             for pid, meta in manifest["pods"].items()}
    memo = GlobalMemoSpace.from_page_tables(
        pages, page_size=manifest["page_size"])
    digests = {int(pid): meta["d"] for pid, meta in manifest["pods"].items()}
    return memo, digests


# --------------------------------------------------------------------------
# Unpodding
# --------------------------------------------------------------------------

class Unpodder:
    """Assemble objects back from pod bytes, loading dependent pods lazily
    through `fetch_pod(pod_id) -> bytes` (the storage read path).  Array
    leaves come back as tensors on `device`."""

    def __init__(self, memo: GlobalMemoSpace,
                 fetch_pod: Callable[[int], bytes],
                 device: Any = "cpu"):
        self.memo = memo
        self.fetch_pod = fetch_pod
        self.device = torch.device(device)
        self._pod_entries: Dict[int, List[Dict[str, Any]]] = {}
        self._values: Dict[Tuple[int, int], Any] = {}  # (pod, local) -> value
        self.loaded_pods: Set[int] = set()

    def _entries(self, pod_id: int) -> List[Dict[str, Any]]:
        if pod_id not in self._pod_entries:
            raw = self.fetch_pod(pod_id)
            obj = msgpack.unpackb(raw, raw=False)
            self._pod_entries[pod_id] = obj["e"]
            self.loaded_pods.add(pod_id)
        return self._pod_entries[pod_id]

    def entry(self, pod_id: int, local: int) -> Dict[str, Any]:
        return self._entries(pod_id)[local]

    def entries(self, pod_id: int) -> List[Dict[str, Any]]:
        """All entries of a pod in local-id order (entry index == local
        memo id — what checkout's assignment reconstruction relies on)."""
        return self._entries(pod_id)

    def resolve(self, ctx_pod: int, vid: int) -> Tuple[int, int]:
        return self.memo.resolve(ctx_pod, vid)

    def value(self, pod_id: int, local: int) -> Any:
        """Materialize the object at (pod, local): a tensor for LEAF, the
        canonical tensor (the same object) for ALIAS, python value for
        SCALAR, dict for CONTAINER."""
        key = (pod_id, local)
        if key in self._values:
            return self._values[key]
        e = self.entry(pod_id, local)
        kind = e["t"]
        if kind == SCALAR:
            val = e["m"]["v"]
        elif kind == LEAF:
            meta = e["m"]
            shape = tuple(meta["shape"])
            dtype = torch_dtype(meta["dtype"])
            parts = []
            for vid in e["r"]:
                cp, cl = self.resolve(pod_id, vid)
                ce = self.entry(cp, cl)
                parts.append(ce["d"])
            buf = bytearray().join(parts)
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if count == 0:
                # torch.frombuffer rejects an empty buffer
                arr = torch.empty(shape, dtype=dtype)
            else:
                arr = torch.frombuffer(buf, dtype=dtype)[:count].reshape(shape)
            val = arr.to(self.device)
        elif kind == ALIAS:
            cp, cl = self.resolve(pod_id, e["m"]["ref"])
            val = self.value(cp, cl)
        elif kind == CONTAINER:
            names = e["m"]["names"]
            val = {}
            for name, vid in zip(names, e["r"]):
                cp, cl = self.resolve(pod_id, vid)
                val[name] = self.value(cp, cl)
        elif kind == CHUNK:
            val = e["d"]
        else:
            raise ValueError(f"unknown node kind {kind!r}")
        self._values[key] = val
        return val
