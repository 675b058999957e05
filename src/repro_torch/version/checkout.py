"""Delta-aware checkout: restore a commit by fetching only what differs.

A naive `load(time_id)` reads every pod of the target manifest from the
store.  But when the caller is *switching* — branch hop, time travel —
most pods of the target are byte-identical to pods of the state already
in memory: pod digests are pure functions of content, so a target pod
whose digest appears among the live pod digests (`Lineage.pod_digests`)
can be re-serialized from the in-memory graph instead of read from
storage.  Checkout therefore pays store reads only for the pods that
actually differ (`StoreStats.read_bytes` scales with the branch delta,
not the model size).

Live bytes are verified, not trusted.  Torch tensors change in place
(``optimizer.step()``, ``add_``), so after a save the live tensors may
no longer hold the bytes the last save's digest tables describe.
Checkout first digests the whole live graph against the last save's
chunk table in one fused pass (`ChangeDetector.verify`, the same kernels
and the same one fetch a warm save pays; `CheckoutStats.n_dirty_chunks`
counts what changed).  Only leaves and pods that are still what they
were are taken from memory; the rest come from the store.

On top of pod-level reuse sits **leaf-level reuse**: a leaf whose full
chunk-digest column in the target manifest matches the live tensor's
current digests is byte-identical to it, so checkout hands the live
tensor *object* back directly (`CheckoutStats.n_leaves_reused`) — no
chunk reassembly, no device→host copy, no upload.  A reused tensor is
therefore shared with the caller's previous state: an in-place update of
one is an update of the other, exactly as the restored and the previous
state would share an aliased leaf.  (After an async save the live
tensors are the save's snapshot, see `Chipmink.save`, so a reused leaf
is the snapshot buffer's view, not the caller's original tensor.)  Pods
holding only such chunks are skipped entirely (their membership is
derived from the live assignment, not by deserializing them).

Pods stored in **delta form** (`delta_chains=True` saves) need no
special handling here: `store.get_pod` walks the chain and replays the
patches, returning the same full bytes the digest names — so the
unpodder, pod-level reuse, and leaf-level reuse all compose with delta
chains unchanged (`CheckoutStats.n_chain_reads` counts fetches that
paid a walk).  Live digest-matching pods are still served from memory
without touching the store at all, chain or no chain.

Restored tensors are writable and lie on the instance's device; an
aliased leaf comes back as one object on both of its paths.

The second half is **post-checkout priming**, which is what keeps the
*next* save incremental instead of a from-scratch fallback:

  * the restored state's ObjectGraph is adopted by `GraphCache` as the
    previous build (stable node ids for the incremental re-walk);
  * the `ChangeDetector` digest table is imported from the manifest's
    persisted chunk-digest table (or recomputed in one batched pass for
    pre-versioning manifests), so the next save diffs against the
    checked-out state; the import drops the device-resident table, and
    the next save re-seeds it with non-blocking uploads, so it still
    pays exactly one blocking fetch;
  * the target's `PodAssignment` is *reconstructed* from the pod entries
    and memo page tables — not re-derived by a policy walk — so the next
    structurally-unchanged save reuses pods/locals/pages bit-identically
    to the commit it branched from, and the pod digests are primed
    straight from the manifest digests.

All of this is the instance's `Lineage` (``ck.lineage``), which the
live state is read from and which the priming rewrites.

`Chipmink.checkout` drains in-flight async saves before calling in here.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Any, Dict, Optional, Set, Tuple

import numpy as np

from ..core.change_detector import pack_digest_table, unpack_digest_table
from ..core.graph import (ALIAS, CHUNK, LEAF, ObjectGraph, build_graph,
                          dtype_name, path_str)
from ..core.memo import GlobalMemoSpace
from ..core.podding import (Pod, PodAssignment, Unpodder, fused_chunk_fetch,
                            open_manifest, serialize_pod)


@dataclasses.dataclass
class CheckoutStats:
    time_id: int
    n_pods: int = 0               # pods in the target manifest
    n_pods_fetched: int = 0       # read from the store (the delta)
    n_pods_live: int = 0          # satisfied without a store read
    n_leaves_reused: int = 0      # leaves handed back as live tensors
    n_chain_reads: int = 0        # fetched pods resolved via a delta chain
    n_dirty_chunks: int = 0       # live chunks changed since the last save
    n_syncs: int = 0              # blocking device fetches (verify + gather)
    read_bytes: int = 0           # store bytes actually read (all links)
    digest_table_imported: bool = False
    t_restore: float = 0.0
    t_prime: float = 0.0

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


def _writable(tree: Any, memo: Dict[int, Any]) -> Any:
    """Deep-map a restored tree so every numpy leaf is writable (a live
    host leaf handed back by leaf reuse may be read-only), preserving
    shared references: an aliased array is copied once and both paths
    keep pointing at the same object.  Unpodded tensors are already
    writable (they own their bytes) and pass through unchanged."""
    if isinstance(tree, dict):
        return {k: _writable(v, memo) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and not tree.flags.writeable:
        got = memo.get(id(tree))
        if got is None:
            got = memo[id(tree)] = tree.copy()
        return got
    return tree


class _ReuseUnpodder(Unpodder):
    """Unpodder that serves digest-matching leaves straight from the live
    tensors (leaf-level checkout reuse).

    Digest equality ⇒ byte equality, but chunk digests do not fold
    shape/dtype — both are re-verified against the entry metadata (the
    dtype by its canonical name, `core.graph.dtype_name`, which needs no
    numpy dtype for bfloat16) before a tensor is handed back; on mismatch
    the leaf falls through to the normal chunk-reassembly path.  A reused
    leaf's chunk entries are never visited, so pods holding only such
    chunks are never fetched.
    """

    def __init__(self, memo: GlobalMemoSpace, fetch_pod,
                 reuse_arrays: Dict[str, Any], stats: CheckoutStats,
                 device: Any):
        super().__init__(memo, fetch_pod, device=device)
        self._reuse = reuse_arrays
        self._stats = stats

    def value(self, pod_id: int, local: int) -> Any:
        key = (pod_id, local)
        if key in self._values:
            return self._values[key]
        e = self.entry(pod_id, local)
        if e["t"] == LEAF:
            arr = self._reuse.get(e["k"])
            if arr is not None:
                meta = e["m"]
                if (tuple(meta["shape"]) == tuple(arr.shape)
                        and meta["dtype"] == dtype_name(arr.dtype)):
                    self._values[key] = arr
                    self._stats.n_leaves_reused += 1
                    return arr
        return super().value(pod_id, local)


def _assignment_from_pods(graph: ObjectGraph, up: Unpodder,
                          memo: GlobalMemoSpace,
                          manifest: Dict[str, Any],
                          entry_keys=None) -> PodAssignment:
    """Rebuild the committed PodAssignment against the restored graph.

    Pod membership and memo locals come from the pod entries themselves
    (entry order *is* local-id order), pages from the manifest — so the
    reconstruction is exact: the next reuse-path save emits the same
    virtual refs, pages, and digests the commit recorded, bit-for-bit.

    `entry_keys(pid) -> keys or None` supplies the key column of a pod
    without deserializing it (checkout derives it from the live
    assignment for digest-matching pods, since the key sequence is part
    of the structural digest) — so pods fully covered by leaf reuse are
    never fetched just to learn their membership.
    """
    pods: Dict[int, Pod] = {}
    node_pod: Dict[int, int] = {}
    node_local: Dict[int, int] = {}
    for pid_str in manifest["pods"]:
        pid = int(pid_str)
        keys = entry_keys(pid) if entry_keys is not None else None
        if keys is None:
            keys = [e["k"] for e in up.entries(pid)]
        pod = Pod(pod_id=pid, depth=0)
        for local, k in enumerate(keys):
            nid = graph.by_key[k]
            node_pod[nid] = pid
            node_local[nid] = local
            pod.node_ids.append(nid)
            pod.size += float(graph.node(nid).size)
        pods[pid] = pod
    edges: Set[Tuple[int, int]] = set()
    for nid, pid in node_pod.items():
        for cid in graph.node(nid).children:
            cp = node_pod[cid]
            if cp != pid:
                edges.add((pid, cp))
    for n in graph.nodes.values():
        if n.kind == ALIAS and n.alias_of is not None:
            canon_id = graph.by_key.get(path_str(n.alias_of))
            if canon_id is not None:
                pa, pb = node_pod[n.node_id], node_pod[canon_id]
                if pa != pb:
                    edges.add((pa, pb))
    return PodAssignment(pods=pods, node_pod=node_pod, node_local=node_local,
                         memo=memo, root_pod=manifest["root_pod"],
                         edges=edges)


def _demanded(graph: ObjectGraph, asg: PodAssignment, live_pods: Set[int],
              reuse_arrays: Dict[str, Any]) -> Set[int]:
    """The live pods the unpodder will serialize: each one holding a node
    that is not a chunk of a reused leaf."""
    out: Set[int] = set()
    for lp in live_pods:
        for nid in asg.pods[lp].node_ids:
            n = graph.node(nid)
            if not (n.kind == CHUNK and path_str(n.path) in reuse_arrays):
                out.add(lp)
                break
    return out


def _verified_live(lin: Any, live_graph: ObjectGraph,
                   live_asg: Optional[PodAssignment],
                   digests: Dict[int, str],
                   packed_target: Optional[Dict[str, bytes]],
                   stats: CheckoutStats
                   ) -> Tuple[Dict[str, Any], Dict[int, int], Dict[str, bytes]]:
    """What checkout may take from the live state: (leaves to hand back,
    target pod id -> live pod id to serialize from memory, chunk payload
    already fetched for those pods).

    Torch tensors change in place, so the last save's digest table proves
    nothing about the live bytes.  One verification pass
    (`ChangeDetector.verify`: the fused digest-and-compare of a save and
    its one fetch) digests the live graph against that table.  A leaf is
    reused only when its *current* chunk digests equal the target's
    column, and a live pod serves a target pod of equal digest only when
    none of its chunks changed.  The chunks of the pods expected to be
    demanded ride along in the same fetch.  A live tensor whose shape or
    dtype no longer matches its leaf cannot be digested against the
    table, so then nothing is taken from memory."""
    for leaf in live_graph.leaf_nodes():
        arr = live_graph.arrays[leaf.key]
        if (tuple(arr.shape) != tuple(leaf.shape)
                or dtype_name(arr.dtype) != leaf.dtype):
            return {}, {}, {}

    def reusable(table: Dict[str, bytes]) -> Dict[str, Any]:
        packed = pack_digest_table(table)
        return {lkey: live_graph.arrays[lkey]
                for lkey, blob in (packed_target or {}).items()
                if packed.get(lkey) == blob and lkey in live_graph.arrays}

    cand_pids: Dict[int, int] = {}
    spec: Set[str] = set()
    if live_asg is not None:
        by_digest = {d.hex(): pid for pid, d in lin.pod_digests.items()}
        cand_pids = {pid: by_digest[d] for pid, d in digests.items()
                     if d in by_digest}
        for lp in _demanded(live_graph, live_asg, set(cand_pids.values()),
                            reusable(lin.detector.export_table())):
            for nid in live_asg.pods[lp].node_ids:
                node = live_graph.node(nid)
                if node.kind == CHUNK:
                    spec.add(node.key)
    report = lin.detector.verify(live_graph, speculate=spec or None)
    stats.n_syncs += report.n_syncs
    stats.n_dirty_chunks = len(report.dirty)
    dirty_pods = ({live_asg.node_pod[live_graph.by_key[k]]
                   for k in report.dirty} if live_asg is not None else set())
    live_pids = {pid: lp for pid, lp in cand_pids.items()
                 if lp not in dirty_pods}
    return reusable(report.digests), live_pids, report.payload


def delta_checkout(ck: Any, time_id: int) -> Tuple[Any, CheckoutStats]:
    """Restore the state of `time_id` into `ck`, delta-aware, and prime
    its lineage for an incremental next save.  Returns (state, stats).

    `ck` is a `Chipmink`; typed as Any to keep the core→version import
    one-directional (core lazily imports this module, never the reverse).
    """
    store = ck.store
    with ck.saver.l_ns:
        manifest = store.get_manifest(time_id)
    memo, digests = open_manifest(manifest)

    stats = CheckoutStats(time_id=time_id, n_pods=len(digests))
    lin = ck.lineage
    live_graph = lin.prev_graph
    live_asg = lin.prev_pods
    reuse_arrays: Dict[str, Any] = {}
    #: target pod id -> live pod id, for pods served from memory
    live_pids: Dict[int, int] = {}
    payload: Dict[str, bytes] = {}
    if live_graph is not None:
        reuse_arrays, live_pids, payload = _verified_live(
            lin, live_graph, live_asg, digests, manifest.get("chunks"), stats)

    reads0 = store.stats.read_bytes
    chain0 = store.stats.chain_reads
    t0 = _time.perf_counter()

    # The live pods' chunk bytes, built lazily on the first live-served
    # pod that is actually demanded: the verification fetch carried the
    # chunks of every pod it expected to be demanded, and only chunks it
    # did not foresee pay one corrective fetch.  A live pod holding only
    # chunks of reused leaves is never demanded, so a checkout fully
    # covered by leaf reuse gathers nothing.
    _live_fetch: Dict[str, Any] = {}

    def live_chunk_bytes(node) -> bytes:
        fn = _live_fetch.get("fn")
        if fn is None:
            nodes = [live_graph.node(nid)
                     for lp in _demanded(live_graph, live_asg,
                                         set(live_pids.values()),
                                         reuse_arrays)
                     for nid in live_asg.pods[lp].node_ids]
            fn, n = fused_chunk_fetch(live_graph, nodes, payload)
            stats.n_syncs += n
            _live_fetch["fn"] = fn
        return fn(node)

    def fetch(pod_id: int) -> bytes:
        live_pid = live_pids.get(pod_id)
        if live_pid is not None:
            # byte-identical pod already in memory: serialize it from the
            # live graph (digest == digest ⇒ bytes == bytes, the same
            # invariant content-addressed dedup already relies on; the
            # pod's chunks were just verified unchanged).
            pod = live_asg.pods[live_pid]
            return serialize_pod(pod, live_graph, live_asg, live_chunk_bytes)
        stats.n_pods_fetched += 1
        return store.get_pod(digests[pod_id])

    up = _ReuseUnpodder(memo, fetch, reuse_arrays, stats, ck.device)
    root_pod = manifest["root_pod"]
    root_entry = up.entry(root_pod, 0)
    restored: Dict[str, Any] = {}
    for name, vid in zip(root_entry["m"]["names"], root_entry["r"]):
        cp, cl = up.resolve(root_pod, vid)
        restored[name] = up.value(cp, cl)
    state = _writable(restored, {})
    stats.t_restore = _time.perf_counter() - t0
    stats.read_bytes = store.stats.read_bytes - reads0
    # delta-stored pods resolve transparently inside store.get_pod (chain
    # walk + patch replay); surface how many fetches paid that walk.
    stats.n_chain_reads = store.stats.chain_reads - chain0

    # ---- post-checkout priming: make the next save() incremental -------
    t0 = _time.perf_counter()
    graph = build_graph(state, chunk_bytes=ck.chunk_bytes)
    if lin.graph_cache is not None:
        lin.graph_cache.adopt(graph)
    packed = manifest.get("chunks")
    if packed:
        lin.detector.import_table(unpack_digest_table(packed))
        stats.digest_table_imported = True
    else:
        # pre-versioning manifest: one batched fingerprint pass over the
        # restored state rebuilds the table the manifest didn't carry.
        lin.detector.detect(graph, None)

    def entry_keys(pid: int):
        lp = live_pids.get(pid)
        if lp is None:
            return None
        return [live_graph.node(nid).key
                for nid in live_asg.pods[lp].node_ids]

    lin.prev_pods = _assignment_from_pods(graph, up, memo, manifest,
                                          entry_keys=entry_keys)
    lin.prev_graph = graph
    lin.pod_digests = {pid: bytes.fromhex(d) for pid, d in digests.items()}
    stats.n_pods_live = stats.n_pods - stats.n_pods_fetched
    stats.t_prime = _time.perf_counter() - t0
    return state, stats
