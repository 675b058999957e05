"""Chipmink: the object store (paper §3.1 user API + full save/load flow),
over torch state on a CUDA device.

    save(state) -> TimeID
    load(names, time_id) -> {name: value}

A save runs the paper's pipeline: build the ObjectGraph → active-variable
filter → change detection (device fingerprints) → podding (LGA) → pod
digests → thesaurus lookup (synonyms) → write dirty pods + manifest.
A load reverses it: manifest → resolve pods (synonyms are content-addressed)
→ unpod only what the requested names reach (partial loading).

Manifests, pods, stores and the meta blobs (refs, leases, the TimeID
counter, the refcount index) are byte-identical to the reference
package's (`repro.core.checkpoint`) for the same state and the same
sequence of calls, but for the values of a manifest's stats block, whose
keys are the reference's less five that nothing read (``t_graph_inc``,
``n_nodes_reused``, ``n_nodes_rebuilt``, ``n_fused_rows``,
``n_pod_digests_reused``): a store written by either package loads,
checks out and passes fsck in the other.

Device.  ``Chipmink(..., device="cuda")`` is the default; without a CUDA
device the constructor raises.  A `torch.Tensor` leaf takes the device
path (batched packer, fingerprint kernel, device-resident digest table,
speculative gather, one counted fetch) and must lie on the instance's
device; an `np.ndarray` leaf takes the host twin.  With ``device="cpu"``
the device path runs the kernels' plain PyTorch versions.  `load`
returns tensors on the instance's device.

Incremental save pipeline (contract)
------------------------------------
With ``incremental=True`` (default) the host-side half of a save scales
with the *delta*, mirroring the device half's batched digest engine:

  * **Stable node ids** — `GraphCache` re-walks only changed subtrees and
    splices reused nodes; a key whose node survives keeps its id, so the
    previous `PodAssignment` (keyed by node id) stays addressable.
  * **Memo-local preservation** — when the build reports zero structural
    changes, the previous assignment (pods, locals, pages, edges) is
    reused verbatim: every untouched pod keeps its memo locals bit-exact,
    and only pods containing dirty chunks or changed scalars re-hash
    their structural digest.  Any structural change falls back to the
    full LGA walk, which — thanks to per-key decision memoization (§7.3)
    — is itself the parity oracle: from-scratch and incremental saves
    produce bit-identical pod bytes and manifests (modulo the timing
    stats block).

Asynchronous saves (``async_mode=True``) and the snapshot rule
--------------------------------------------------------------
`save()` builds the graph on the caller's thread and hands the rest of
the save (digest, podding, gather, write) to the podding thread
(`AsyncSaver`, up to ``async_depth`` saves in flight, bodies strictly
FIFO).  Torch tensors change in place (``optimizer.step()``, ``add_``,
``copy_``), so a reference to a leaf is not a snapshot of it.  Before
`save()` returns, **every tensor leaf is snapshotted**, whatever its
size: one flat buffer on the instance's device filled by a few launches
(`kernels.ops.snapshot_tensors`), on the caller's *current stream*, and
the save's graph then reads only the snapshot's views.  So:

  * an in-place update the caller enqueues on the stream that called
    `save()` runs after the copy and never reaches the commit; work on
    another stream must first synchronize with that one;
  * the body runs under ``torch.cuda.device(device)`` on a dedicated side
    stream that first waits on an event recorded after the snapshot; the
    snapshot buffer is marked used by that stream (`record_stream`), so
    the caching allocator cannot hand its memory out while the body still
    reads it; `wait()` orders the caller's stream after the side stream;
  * the caller pays no blocking sync (the snapshot, the event and the
    submit are all asynchronous); the body pays the save's usual fetches
    (exactly one on a warm sparse save);
  * there is no fallback: if the side stream or the snapshot fails,
    `save()` raises and no body is enqueued.

Per-save stats ``n_snapshot_bytes`` and ``t_snapshot`` (host time to
enqueue it) record the snapshot.  It is taken once a pipeline slot is
free (the ``prepare`` step of `AsyncSaver.submit`), so a save that
stalls on a full pipeline holds no extra copy while it waits.  Host numpy
leaves follow the reference's copy-on-submit rule: leaves no larger than
``copy_on_submit_bytes`` (1 MiB default) are copied on the caller's
thread (``n_leaf_copies``); larger writable ones keep the
must-not-mutate-before-`wait()` rule, surfaced per ``large_leaf_action``
(``"warn"`` once per key, ``"raise"``, or ``"ignore"``;
``copy_on_submit_bytes=0`` disables copies and the guard).

Single-sync save (``fused=True``, default)
------------------------------------------
The device half of a save is one round-trip: the fused digest kernels
compare against the device-resident previous table and the packed word
rows of *speculated* chunks (flip-EMA above 0.25, expanded to pod
granularity plus the pods of changed scalars) ride along in the same
fetch as the digests and dirty flags.  The gather phase then serializes
written pods from those prefetched bytes; only
mispredicted-dirty chunks pay one corrective batched fetch
(``n_corrective_syncs``), so a warm sparse save costs exactly one
blocking device sync and any save at most two.  ``fused=False``
restores the two-sync path (digest fetch + payload gather) and
``batched=False`` the per-leaf path; manifests are bit-identical on
every rung.

Dedup through the thesaurus, the active-variable filter and flip
tracking always run (the paper's §8.8/§8.9 ablations are the reference
package's ``enable_cd`` and ``enable_avf``); ``async_mode=False`` is the
synchronous baseline and ``incremental=False`` restores the from-scratch
host path.

Lineage
-------
What one save hands to the next save of the same history is one
`Lineage`: the change detector (with its device-resident digest table),
the graph cache, the flip tracker, the previous `PodAssignment`, graph
and pod digests, and the head TimeID the next commit chains to.
``Chipmink.lineage`` is the one in use; `save()` takes it once, at the
call, and the save's body reads and writes only that object.
`SessionService` keeps one per session and swaps it onto a pool
instance; `delta_checkout` primes the instance's.

Delta-chain pod storage (``delta_chains=True``)
-----------------------------------------------
When a reuse-path save re-serializes a pod that the detector mask shows
changed in only a few chunks (or scalars), the pod can be stored as a
chunk-granular binary delta against its parent-commit pod instead of
whole (`core/delta.py`).  The patch set comes for free: under
assignment reuse with no structural change, only CHUNK entries in
``report.dirty`` and SCALAR entries in ``scalar_changed_keys`` can
differ from the parent blob, so those entry indices ARE the delta (no
extra device fetch).  `DeltaPolicy` admits the delta only when its
bytes plus an expected chain-reconstruction charge beat the whole blob,
and never past ``max_chain_depth`` links from a whole base.  The
manifest records the base as ``pods[pid]["delta_of"]``; `get_pod`
reconstructs the full bytes transparently.  Per-save stats:
``n_delta_pods``, ``t_delta_encode``, ``chain_depth_max``.  Default off.

Versioning
----------
Every save is a *commit* whose manifest records its parent (HEAD by
default) and the save's chunk-digest table (``"chunks"``); a commit DAG
with branch refs / tags / HEAD persists in the store.  ``branch``,
``tag``, ``log``, ``diff`` and ``delete_branch`` mirror git;
``checkout(ref)`` restores a commit delta-aware (store reads scale with
the branch delta; untouched leaves come back as the live tensor objects,
shared with the caller's previous state, once one digest pass has shown
them unchanged since the last save) and primes the pipeline so the
next save is incremental and single-sync (`version/checkout.py`);
``gc()`` mark-and-sweeps what no ref reaches and prunes the thesaurus.

Durability & recovery
---------------------
Every save is a pods → manifest → refs transaction (refs via
`BaseStore.compare_and_put_meta`); ``fsck_on_open`` (default True) runs
the recovery scan before the first save of a reopened store
(``"deep"`` validates every pod's bytes), `fsck()` reruns it, and
transient `OSError`s in the write phase retry under ``retry_policy``.

Multi-writer (``multi_writer=True``)
------------------------------------
The instance holds a shared writer lease (`core.lease`; TTL
``lease_ttl_s``, renewed by a heartbeat thread unless
``lease_heartbeat=False``, and inline at every save); TimeIDs come from
a CAS counter meta blob (``TID_COUNTER_META_KEY``); every save
registers a save intent (TimeID, parent, every manifest digest) before
any pod byte lands, re-verifies aliased pods after it, and fences the
refs CAS (`LeaseLost` aborts publication).  ``gc()`` runs under the
exclusive gc lease with the sweep fence; ``fsck()`` reaps dead writers'
leases while honoring live peers' intents.  ``close()`` drains the
pipeline, stops the heartbeat and releases the lease.  ``shared_tids``
routes TimeIDs through the CAS counter without leases (a pool of
instances on one store); ``max_refs_cas_retries`` / ``refs_cas_backoff``
bound the refs CAS loop.

Refcount GC (``refcounts=True``)
--------------------------------
A persistent refcount index (`version/refcount.py`, meta key
``pod_refcounts``) is updated between every manifest put and refs CAS.
``evict_branch(name)`` deletes a branch and reclaims its exclusive
commits and pods in O(branch delta), freeing exactly what a full
mark-and-sweep would; ``gc()`` then drains the backlog of
`delete_branch` tips the same way and ``gc(full=True)`` forces the
mark-and-sweep oracle and trues the index up.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import msgpack
import numpy as np
import torch

from ..kernels.ops import resolve_device, snapshot_tensors
from .active_filter import ActiveVariableFilter
from .async_saver import AsyncSaver
from .change_detector import ChangeDetector, ChangeReport, pack_digest_table
from .delta import DeltaPolicy, encode_pod_delta
from .faults import RetryPolicy, call_with_retries
from .graph import CHUNK, ObjectGraph, build_graph
from .graph_cache import GraphCache, IncrementalBuildInfo
from .lease import Lease, LeaseHeartbeat, LeaseLost, LeaseManager
from .lga import LGA, PoddingPolicy
from .podding import (PodAssignment, Unpodder, batched_chunk_fetch,
                      fused_chunk_fetch, open_manifest, pod_blob, pod_graph,
                      pod_structural_digest)
from .store import BaseStore, MemoryStore
from .thesaurus import PodThesaurus
from .trace import span
from .volatility import FlipTracker

TimeID = int

#: meta blob holding the next unissued TimeID (multi-writer mode only):
#: a CAS counter, so concurrent writers never mint the same commit id.
TID_COUNTER_META_KEY = "tid_counter"

#: stage timers and counters of `save_stats` that a manifest's stats
#: block leaves out, so that the block holds the reference package's keys
#: (less five, module docstring) and the two packages' manifests of a
#: save are of one size
SPAN_ONLY_STATS = frozenset({
    "t_slot_wait", "t_digest_call", "t_track", "t_intent",
    "t_commit_manifest", "t_commit_refcounts", "t_commit_refs",
    "n_track_rows", "n_track_rows_built", "chunks_by_group",
    "dirty_by_group", "written_chunk_bytes", "clean_written_bytes",
    "n_refcount_coded", "n_refcount_whole", "t_write_pack", "t_write_put",
    "n_pods_serialized", "n_pods_from_layout"})

#: entries per page of a pod's memo locals (a manifest's ``page_size``)
MEMO_PAGE_SIZE = 1024

#: blob bytes the write phase packs before it puts them (a batch ends
#: with the pod that reaches it), so a save of many GB never holds all
#: of its blobs at once
WRITE_BATCH_BYTES = 64 << 20


def written_chunk_bytes(graph: ObjectGraph, asg: PodAssignment,
                        report: ChangeReport, stored: Sequence[int],
                        stored_delta: Sequence[int]) -> Tuple[int, int]:
    """(payload bytes of the chunks the pods `stored` hold, those of them
    whose chunk is clean): the clean bytes a save drags into the pods its
    dirty chunks make it write.  A pod stored as a delta (`stored_delta`)
    holds its dirty chunks alone.  Array work over the assignment's chunk
    table (laid out once per assignment) and the detector's per-row dirty
    flags; nothing here runs per chunk."""
    if not stored or report.row_changed is None:
        return 0, 0
    if asg.chunk_table is None:
        asg.chunk_table = _chunk_table(graph, asg)
    leaves, n_pods, pod, leaf, ci, size = asg.chunk_table
    # per pod id: 0 not stored, 1 stored whole, 2 stored as a delta
    how = np.zeros(n_pods, np.int8)
    how[np.fromiter(stored, np.int64, len(stored))] = 1
    how[np.fromiter(stored_delta, np.int64, len(stored_delta))] = 2
    at = how[pod]
    sel = at > 0
    start = np.fromiter((report.leaf_rows.get(k, -1) for k in leaves),
                        np.int64, len(leaves))
    r0, c, nbytes = start[leaf[sel]], ci[sel], size[sel]
    dirty = np.zeros(len(c), dtype=bool)
    have = r0 >= 0                      # a leaf not digested is clean
    dirty[have] = report.row_changed[r0[have] + c[have]]
    kept = dirty | (at[sel] == 1)
    return int(nbytes[kept].sum()), int(nbytes[kept & ~dirty].sum())


def _chunk_table(graph: ObjectGraph, asg: PodAssignment) -> Tuple:
    """(leaf paths, 1 + the largest pod id, then per chunk node: its pod
    id, its leaf's index in those paths, its chunk index, its bytes)."""
    leaves: Dict[str, int] = {}
    rows: List[Tuple[int, int, int, int]] = []
    for nid, pid in asg.node_pod.items():
        node = graph.node(nid)
        if node.kind == CHUNK:
            li = leaves.setdefault("/".join(node.path), len(leaves))
            rows.append((pid, li, node.chunk_index, node.size))
    cols = np.asarray(rows, np.int64).reshape(-1, 4).T
    return (list(leaves), max(asg.pods) + 1, *cols)


@dataclasses.dataclass(eq=False)
class Lineage:
    """The state a save hands to the next save of the same history
    (module docstring, "Lineage")."""

    detector: ChangeDetector
    graph_cache: Optional[GraphCache]
    tracker: FlipTracker
    #: the commit the next save chains to by default
    head: Optional[TimeID] = None
    prev_pods: Optional[PodAssignment] = None
    prev_graph: Optional[ObjectGraph] = None
    #: the previous save's structural digest per pod id
    pod_digests: Dict[int, bytes] = dataclasses.field(default_factory=dict)

    def forget(self, head: Optional[TimeID]) -> None:
        """Drop what the next save would chain from (the assignment, the
        graph and the pod digests), so it re-pods and re-hashes from its
        own graph, and chain it to `head`.  Invalidating the graph cache
        is the caller's: a failed body, which calls this on the podding
        thread, must not touch it."""
        self.prev_pods = None
        self.prev_graph = None
        self.pod_digests = {}
        self.head = head


class Chipmink:
    def __init__(
        self,
        store: Optional[BaseStore] = None,
        policy: Optional[PoddingPolicy] = None,
        *,
        chunk_bytes: int = 1 << 22,
        async_mode: bool = False,
        async_depth: int = 2,
        incremental: bool = True,
        fused: bool = True,
        batched: bool = True,
        copy_on_submit_bytes: int = 1 << 20,
        seed: int = 0,
        retry_policy: Optional[RetryPolicy] = None,
        fsck_on_open: Any = True,
        multi_writer: bool = False,
        lease_ttl_s: float = 10.0,
        lease_heartbeat: bool = True,
        max_refs_cas_retries: Optional[int] = None,
        refs_cas_backoff: Optional[RetryPolicy] = None,
        delta_chains: bool = False,
        delta_policy: Optional[DeltaPolicy] = None,
        refcounts: bool = False,
        shared_tids: bool = False,
        large_leaf_action: str = "warn",
        device: Any = "cuda",
    ) -> None:
        if large_leaf_action not in ("warn", "raise", "ignore"):
            raise ValueError(
                f"large_leaf_action must be 'warn', 'raise' or 'ignore', "
                f"got {large_leaf_action!r}")
        self.device = resolve_device(device)
        self.store = store if store is not None else MemoryStore()
        self.policy = policy if policy is not None else LGA()
        self.chunk_bytes = chunk_bytes
        self.async_mode = async_mode
        self.incremental = incremental
        self.fused = fused
        self.batched = batched
        self.seed = seed
        self.thesaurus = PodThesaurus()
        self.avf = ActiveVariableFilter()
        self.saver = AsyncSaver(depth=async_depth)
        self.copy_on_submit_bytes = copy_on_submit_bytes
        self.large_leaf_action = large_leaf_action
        self._large_leaves_warned: Set[str] = set()
        #: side stream of the async save bodies (CUDA only; made lazily)
        self._side_stream: Optional[torch.cuda.Stream] = None
        self.delta_chains = delta_chains
        self.delta_policy = (delta_policy if delta_policy is not None
                             else DeltaPolicy())
        self.retry_policy = (retry_policy if retry_policy is not None
                             else RetryPolicy())
        # Multi-writer mode: lease manager + lazily-acquired writer lease.
        self.leases: Optional[LeaseManager] = (
            LeaseManager(self.store, ttl_s=lease_ttl_s)
            if multi_writer else None)
        self._writer_lease: Optional[Lease] = None
        self._heartbeat: Optional[LeaseHeartbeat] = None
        self._lease_heartbeat = lease_heartbeat
        # Recovery scan before anything reads the store: a previous
        # process may have died mid-transaction.  True = quick (existence
        # + non-empty of every referenced pod); "deep" additionally
        # validates every pod's bytes.
        self.last_fsck = None
        if fsck_on_open:
            from ..version import fsck as _fsck
            self.last_fsck = _fsck(self.store,
                                   deep=(fsck_on_open == "deep"),
                                   leases=self.leases)
        # Resume TimeIDs after the store's newest manifest: a reopened
        # store must append commits, never overwrite them.
        existing = self.store.list_time_ids()
        self._next_time = (existing[-1] + 1) if existing else 1
        # runtime import: version depends on core, never the reverse at
        # module import time.  Built eagerly so the caller thread and the
        # podding thread share one DAG instance from the start.
        from ..version import CommitDAG
        self.versions = CommitDAG(self.store,
                                  max_cas_retries=max_refs_cas_retries,
                                  cas_backoff=refs_cas_backoff)
        #: its head resumes from the persisted HEAD, so a reopened
        #: instance chains its first commit to the old tip.
        self.lineage = self.new_lineage(head=self.versions.head_commit())
        self.last_checkout_stats = None
        self.save_stats: List[Dict[str, Any]] = []
        self._shared_tids = shared_tids
        # Refcount index (incremental GC): loaded-or-rebuilt now so the
        # first evict/gc never pays a surprise full scan mid-request.
        self.refcounts = None
        if refcounts:
            from ..version.refcount import RefcountIndex
            self.refcounts = RefcountIndex(self.store)
            self.refcounts.ensure()
        #: tips orphaned by delete_branch, awaiting an incremental gc()
        self._gc_backlog: List[TimeID] = []

    def new_lineage(self, head: Optional[TimeID] = None) -> Lineage:
        """A lineage of this instance's settings with nothing to chain
        from but `head`: its first save walks, pods and digests afresh."""
        return Lineage(
            detector=ChangeDetector(chunk_bytes=self.chunk_bytes,
                                    seed=self.seed, fused=self.fused,
                                    batched=self.batched, device=self.device),
            graph_cache=(GraphCache(chunk_bytes=self.chunk_bytes)
                         if self.incremental else None),
            tracker=FlipTracker(), head=head)

    # ------------------------------------------------------------------
    # multi-writer plumbing (leases, fenced TimeIDs)
    # ------------------------------------------------------------------
    def _alloc_time_id(self) -> TimeID:
        """Next TimeID.  Single-writer: the local counter.  Multi-writer
        (or ``shared_tids``): a CAS counter meta blob, seeded no lower
        than the local counter (which itself started past the newest
        on-disk manifest), so two writers never mint the same commit id."""
        if self.leases is None and not self._shared_tids:
            tid = self._next_time
            self._next_time += 1
            return tid
        while True:
            cur = self.store.get_meta(TID_COUNTER_META_KEY)
            floor = self._next_time
            if cur is not None:
                floor = max(floor, msgpack.unpackb(cur, raw=False))
            blob = msgpack.packb(floor + 1, use_bin_type=True)
            if self.store.compare_and_put_meta(TID_COUNTER_META_KEY, cur,
                                               blob):
                self._next_time = floor + 1
                return floor

    def _ensure_writer_lease(self) -> Optional[Lease]:
        """The instance's writer lease: acquired lazily, renewed inline
        when past half-TTL, re-acquired after a loss (its next save
        re-registers its intent under the new fence token)."""
        if self.leases is None:
            return None
        lease = self._writer_lease
        if lease is not None:
            if self._heartbeat is not None and self._heartbeat.lost:
                lease = None
            else:
                try:
                    if self.leases.now() >= lease.expires - lease.ttl_s / 2:
                        self.leases.renew(lease)
                    return lease
                except LeaseLost:
                    lease = None
        if self._heartbeat is not None:
            self._heartbeat.stop()
            self._heartbeat = None
        lease = self.leases.acquire_writer()
        self._writer_lease = lease
        if self._lease_heartbeat:
            self._heartbeat = LeaseHeartbeat(self.leases, lease).start()
        return lease

    def close(self) -> List[BaseException]:
        """Shut down: drain the save pipeline (returning — not raising —
        any pending save errors), stop the heartbeat, and release the
        writer lease so peers need not wait out its TTL.  Idempotent."""
        errors = self.saver.drain()
        self._join_side_stream()
        if self._heartbeat is not None:
            self._heartbeat.stop()
            self._heartbeat = None
        if self.leases is not None and self._writer_lease is not None:
            try:
                self.leases.release(self._writer_lease)
            except Exception:
                pass                  # store down: the lease just expires
            self._writer_lease = None
        return errors

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def save(
        self,
        state: Any,
        *,
        accessed_vars: Optional[Iterable[str]] = None,
        touched_prefixes: Optional[Iterable[str]] = None,
        readonly_paths: Optional[Set[str]] = None,
        parent: Optional[TimeID] = None,
        branch: Optional[str] = None,
    ) -> TimeID:
        lin = self.lineage
        with span("save") as sp:
            time_id = self._alloc_time_id()
            sp.time_id = time_id
            if parent is None:
                if branch is not None:
                    # commit onto a named ref: chain to ITS tip (None for
                    # a branch this commit will create), never to local
                    # HEAD.
                    parent = self.versions.branches.get(branch)
                else:
                    parent = lin.head  # commit chains to HEAD by default

            stats: Dict[str, Any] = {"time_id": time_id}
            with span("save.graph", stats, "t_graph"):
                if lin.graph_cache is not None:
                    graph, ginfo = lin.graph_cache.build(state)
                else:
                    graph = build_graph(state, chunk_bytes=self.chunk_bytes)
                    ginfo = None
            stats["n_leaf_copies"] = 0

            def work() -> None:
                self._save_body(lin, sp, stats, graph, ginfo, accessed_vars,
                                touched_prefixes, readonly_paths, parent,
                                branch)

            if self.async_mode:
                ready: List[Optional[torch.cuda.Event]] = []

                def body() -> None:
                    if ready[0] is None:
                        work()
                        return
                    with torch.cuda.device(self.device), \
                            torch.cuda.stream(self._side_stream):
                        self._side_stream.wait_event(ready[0])
                        work()

                try:
                    # overlapped; FIFO on the podding thread.  The
                    # snapshot is taken once a pipeline slot is free, so a
                    # stalled save holds no copy while it waits.  May
                    # re-raise a PREVIOUS save's failure, in which case
                    # THIS save is dropped (its body never enqueued), as
                    # it is when the snapshot fails.
                    self.saver.submit(body, prepare=lambda: ready.append(
                        self._snapshot(graph, time_id, stats)), stats=stats)
                except BaseException:
                    # The graph cache already advanced for the dropped
                    # save, so a later identical state would diff as
                    # "unchanged" against a build that never persisted.
                    # Invalidating the cache forces the next save to
                    # rebuild from scratch; queued bodies may still re-arm
                    # the lineage's assignment and pod digests, but a
                    # from-scratch build never consults them.
                    if lin.graph_cache is not None:
                        lin.graph_cache.invalidate()
                    raise
            else:
                work()
            lin.head = time_id
        return time_id

    def _snapshot(self, graph: ObjectGraph, time_id: TimeID,
                  stats: Dict[str, Any]) -> Optional[torch.cuda.Event]:
        """Async-mode snapshot on the caller's thread (see the snapshot
        rule in the module docstring): every tensor leaf of
        ``graph.arrays`` is replaced by its view into a fresh buffer
        copied on the current stream (a tensor on another device
        raises); small writable numpy leaves are copied
        (copy-on-submit).  Writes the snapshot's entries of the save's
        ``stats`` and returns the event the side stream must wait on
        (None off CUDA)."""
        with span("save.snapshot", stats, "t_snapshot"):
            tensor_keys: List[str] = []
            n_leaf_copies = 0
            large_leaves: List[str] = []
            for key, arr in graph.arrays.items():
                if isinstance(arr, torch.Tensor):
                    if arr.device != self.device:
                        raise ValueError(f"leaf {key!r} is on {arr.device}, "
                                         f"not on {self.device}")
                    tensor_keys.append(key)
                elif (isinstance(arr, np.ndarray) and arr.flags.writeable
                        and self.copy_on_submit_bytes > 0):
                    if arr.nbytes <= self.copy_on_submit_bytes:
                        graph.arrays[key] = arr.copy()
                        n_leaf_copies += 1
                    else:
                        large_leaves.append(key)
            if large_leaves and self.large_leaf_action != "ignore":
                msg = (
                    f"async save {time_id}: host leaf(s) "
                    f"{sorted(large_leaves)[:4]}"
                    f"{'...' if len(large_leaves) > 4 else ''} exceed "
                    f"copy_on_submit_bytes={self.copy_on_submit_bytes} "
                    "and are snapshotted BY REFERENCE — mutating them in "
                    "place before wait() returns corrupts the in-flight "
                    "save.  Either raise copy_on_submit_bytes past the "
                    "largest host leaf, call wait() before mutating, or "
                    "silence with large_leaf_action='ignore'.")
                if self.large_leaf_action == "raise":
                    raise ValueError(msg)
                fresh = [k for k in large_leaves
                         if k not in self._large_leaves_warned]
                if fresh:
                    self._large_leaves_warned.update(fresh)
                    warnings.warn(msg, RuntimeWarning, stacklevel=3)

            cuda = self.device.type == "cuda"
            if cuda and self._side_stream is None:
                self._side_stream = torch.cuda.Stream(device=self.device)
            n_bytes = 0
            if tensor_keys:
                views, buf = snapshot_tensors([graph.arrays[k]
                                               for k in tensor_keys])
                graph.arrays.update(zip(tensor_keys, views))
                n_bytes = buf.numel()
                if cuda:
                    # the body reads the buffer on the side stream: its memory
                    # must not return to the caller stream's pool before then.
                    buf.record_stream(self._side_stream)
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
            stats.update(n_leaf_copies=n_leaf_copies, n_snapshot_bytes=n_bytes)
            return ready

    def _join_side_stream(self) -> None:
        """Order the caller's current stream after every body's device
        work (no host sync)."""
        if self._side_stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(
                self._side_stream)

    def wait(self) -> None:
        """Join every in-flight save (re-raising pending save errors)."""
        try:
            self.saver.wait()
        finally:
            self._join_side_stream()

    def _save_body(self, lin, save_span, stats, graph, ginfo, accessed_vars,
                   touched_prefixes, readonly_paths, parent,
                   branch=None) -> None:
        try:
            with span("save.body", stats, "t_body", cpu_key="t_body_cpu",
                      parent=save_span):
                self._save_body_inner(lin, stats, graph, ginfo,
                                      accessed_vars, touched_prefixes,
                                      readonly_paths, parent, branch)
        except BaseException as exc:
            # A half-applied save poisons the reuse chain: the graph cache
            # has already advanced, so the next save must re-pod and
            # re-hash from its own graph rather than trust artifacts of a
            # save that never finished.  The lineage must not name the
            # failed TimeID (it has no manifest) as a parent: fall back to
            # the last commit that actually landed.
            lin.forget(self.versions.branches.get(branch)
                       if branch is not None
                       else self.versions.head_commit())
            # the failed save's intent pins nothing worth keeping: drop
            # it (best-effort).  A save fenced out by LeaseLost forgets
            # its lease so the next save re-acquires under a fresh token.
            if self.leases is not None and self._writer_lease is not None:
                if isinstance(exc, LeaseLost):
                    self._writer_lease = None
                else:
                    try:
                        self.leases.clear_intent(self._writer_lease)
                    except Exception:
                        self._writer_lease = None
            raise

    @staticmethod
    def _speculate(lin: Lineage, graph: ObjectGraph,
                   ginfo: Optional[IncrementalBuildInfo]) -> Optional[Set[str]]:
        """Speculative dirty set for the fused single-sync save.

        Seeds: chunk keys whose flip EMA exceeds 0.25
        (`FlipTracker.predicted`) plus keys of scalars the incremental
        build saw change (their pods re-serialize this save even though
        no chunk flipped — the step counter is the canonical case).

        The seed set is then expanded to **pod granularity** against the
        previous assignment: `serialize_pod` needs every chunk of a
        written pod, so speculating a chunk without its pod siblings
        would still pay the corrective gather.  Expansion requires the
        previous assignment to still describe this graph — same
        condition as assignment reuse (no structural change); otherwise
        speculation is skipped (a from-scratch save is all-dirty anyway
        and pays its one corrective gather).
        """
        asg = lin.prev_pods
        if (not lin.detector.fused or asg is None or ginfo is None
                or ginfo.from_scratch or ginfo.structural_change):
            return None
        seeds = lin.tracker.predicted()
        seeds.update(ginfo.scalar_changed_keys)
        pods: Set[int] = set()
        for key in seeds:
            nid = graph.by_key.get(key)
            if nid is not None and nid in asg.node_pod:
                pods.add(asg.node_pod[nid])
        out: Set[str] = set()
        for pid in pods:
            for nid in asg.pods[pid].node_ids:
                node = graph.node(nid)
                if node.kind == CHUNK:
                    out.add(node.key)
        return out or None

    def _delta_of(self, pod, graph: ObjectGraph, data: bytes,
                  base_hex: str, dirty, scalar_changed: Set[str]
                  ) -> Optional[Tuple[bytes, int]]:
        """(delta blob, chain depth) when `data`, the blob of a pod whose
        previous blob was `base_hex`, is to be stored as a delta of that
        blob; None when it is to be stored whole."""
        try:
            # depth the new pod would sit at if chained to base; a
            # missing/broken/cyclic base chain disqualifies.
            depth = self.store.pod_chain_depth(base_hex) + 1
        except (FileNotFoundError, ValueError):
            return None
        if depth > self.delta_policy.max_chain_depth:
            return None
        changed_locals = [
            i for i, nid in enumerate(pod.node_ids)
            if ((n := graph.node(nid)).kind == CHUNK and n.key in dirty)
            or n.key in scalar_changed]
        cand = encode_pod_delta(data, base_hex, changed_locals)
        if not self.delta_policy.admit(len(cand), len(data), depth):
            return None
        return cand, depth

    def _put_batch(self, batch: List[tuple], blobs: List[bytes],
                   deltas: Dict[int, Tuple[str, int]]
                   ) -> Tuple[List[bool], int]:
        """Put a batch of packed pods (`BaseStore.put_pods`; the pods of
        `batch`, entries of `to_write`, with their `blobs`, those indexed
        in `deltas` as delta blobs) and enter each pod that landed in the
        thesaurus, in order.  A transient error retries from the first
        pod that did not land, which gets the retries a pod put alone
        would get; a crash leaves thesaurus entries for the landed pods
        alone.  Returns (each pod's put result, retries)."""
        landed: List[bool] = []

        def put_rest() -> None:
            with self.saver.l_ns:
                start = len(landed)
                try:
                    self.store.put_pods(
                        zip((e[2] for e in batch[start:]), blobs[start:],
                            (j in deltas for j in range(start, len(batch)))),
                        landed)
                finally:
                    self.thesaurus.insert_many(
                        (e[3], e[2]) for e in batch[start:len(landed)])

        _, n_retries = call_with_retries(put_rest, self.retry_policy,
                                         progress=landed.__len__)
        return landed, n_retries

    def _save_body_inner(self, lin, stats, graph, ginfo, accessed_vars,
                         touched_prefixes, readonly_paths, parent,
                         branch=None) -> None:
        time_id = stats["time_id"]
        with span("save.avf", stats, "t_avf"):
            active = self.avf.active_leaves(
                graph,
                readonly_paths=readonly_paths,
                touched_prefixes=touched_prefixes,
                prior_pods=(lin.prev_pods if accessed_vars is not None
                            else None),
                prior_graph=lin.prev_graph,
                accessed_vars=accessed_vars,
            )
            stats["n_leaves"] = len(list(graph.leaf_nodes()))
            stats["n_active_leaves"] = len(active)

        with span("save.digest", stats, "t_digest"):
            spec = self._speculate(lin, graph, ginfo)
            report = lin.detector.detect(graph, active, speculate=spec,
                                         stats=stats)
            stats["n_chunks"] = len(report.digests)
            stats["n_dirty_chunks"] = len(report.dirty)
            stats["chunks_by_group"] = report.chunks_by_group
            stats["dirty_by_group"] = report.dirty_by_group
        stats["n_digest_syncs"] = report.n_syncs
        stats["n_spec_predicted"] = len(spec) if spec else 0
        stats["n_spec_hits"] = report.n_spec_hits
        stats["n_spec_misses"] = report.n_spec_misses

        with span("save.track", stats, "t_track"):
            stats["n_track_rows"] = lin.tracker.observe(
                graph, report.dirty, lin.tracker.chunk_keys(graph, active))
            # the tracker builds no feature row; the counter stays for
            # the benchmark's `track_reuse_pct.*` readers
            stats["n_track_rows_built"] = 0

        # podding: reuse the previous assignment verbatim when the graph
        # structure is unchanged (memo locals preserved, §7.3 stability);
        # otherwise rerun the full LGA walk — the parity oracle — with the
        # rebuilt-key set so feature preparation stays incremental.
        with span("save.podding", stats, "t_podding"):
            pods_reused = (self.incremental and ginfo is not None
                           and not ginfo.from_scratch
                           and not ginfo.structural_change
                           and lin.prev_pods is not None)
            if pods_reused:
                asg = lin.prev_pods
                stats["n_pods_reused"] = len(asg.pods)
            else:
                asg = pod_graph(graph, self.policy,
                                flip_ema=lin.tracker.ema,
                                memo_page_size=MEMO_PAGE_SIZE,
                                changed_keys=(ginfo.rebuilt_keys
                                              if ginfo is not None else None))
                stats["n_pods_reused"] = 0
            stats["n_pods"] = len(asg.pods)

        # decide phase: structural digests + synonym lookups; no payload
        # bytes move yet.  With a reused assignment, only pods touched by
        # dirty chunks or changed scalar values re-hash their digest; the
        # rest reuse the previous save's digest (bit-identical: the digest
        # is a pure function of unchanged inputs).
        with span("save.decide", stats, "t_decide"):
            touched_pods = None
            if pods_reused and lin.pod_digests:
                touched_pods = set()
                for key in report.dirty:
                    nid = graph.by_key.get(key)
                    if nid is not None:
                        touched_pods.add(asg.node_pod[nid])
                for key in (ginfo.scalar_changed_keys if ginfo else ()):
                    nid = graph.by_key.get(key)
                    if nid is not None:
                        touched_pods.add(asg.node_pod[nid])
            pods_meta: Dict[int, Dict[str, Any]] = {}
            written = aliased = 0
            bytes_before = self.store.total_bytes()
            #: the parent commit's digest per pod id — the delta base each
            #: touched pod would chain to (captured before new_digests
            #: lands).
            prev_pod_digests = lin.pod_digests
            new_digests: Dict[int, bytes] = {}
            to_write: List[tuple] = []        # (pid, pod, dig_hex, digest)
            aliased_entries: List[tuple] = []  # same shape; dedup-skipped
            for pid, pod in asg.pods.items():
                if touched_pods is not None and pid not in touched_pods \
                        and pid in prev_pod_digests:
                    digest = prev_pod_digests[pid]
                else:
                    digest = pod_structural_digest(pod, graph, asg,
                                                   report.digests)
                new_digests[pid] = digest
                dig_hex = digest.hex()
                with self.saver.l_ns:
                    ref = self.thesaurus.lookup(digest)
                if ref is None:
                    to_write.append((pid, pod, dig_hex, digest))
                else:
                    aliased += 1              # synonymous pod (§4.2)
                    aliased_entries.append((pid, pod, dig_hex, digest))
                pods_meta[pid] = {
                    "d": dig_hex,
                    "pages": (asg.memo.pods[pid].pages
                              if pid in asg.memo.pods else []),
                    "n": len(pod.node_ids),
                }
            lin.pod_digests = new_digests

        # intent phase (multi-writer): declare the commit — its TimeID,
        # its parent and every digest the manifest will reference — under
        # the writer lease BEFORE any pod byte lands and before dedup is
        # trusted.  Aliased pods are then re-verified: a sweep that ran
        # before the intent landed may have deleted the blob the
        # thesaurus still points at, in which case the pod is rewritten.
        lease = None
        n_alias_rewrites = 0
        if self.leases is not None:
            with span("save.intent", stats, "t_intent"):
                lease = self._ensure_writer_lease()
                self.leases.set_intent(
                    lease,
                    time_ids=tuple(t for t in (time_id, parent)
                                   if t is not None),
                    digests=sorted({m["d"] for m in pods_meta.values()}))
                for pid, pod, dig_hex, digest in aliased_entries:
                    if not self.store.has_pod(dig_hex):
                        to_write.append((pid, pod, dig_hex, digest))
                        with self.saver.l_ns:
                            self.thesaurus.prune([dig_hex])
                        aliased -= 1
                        n_alias_rewrites += 1
        stats["n_alias_rewrites"] = n_alias_rewrites

        # gather phase.  Fused path: payload bytes of speculated chunks
        # already arrived with the digest fetch; only mispredicted chunks
        # pay one corrective batched fetch (zero when speculation covered
        # every written pod — the single-sync save).  Non-fused: ONE
        # batched device fetch for every chunk of every dirty pod (clean
        # pods never touch the device either way).
        with span("save.gather", stats, "t_gather"):
            gather_nodes = [graph.node(nid) for _, pod, _, _ in to_write
                            for nid in pod.node_ids]
            if lin.detector.fused:
                chunk_bytes, gather_syncs = fused_chunk_fetch(
                    graph, gather_nodes, report.payload)
                stats["n_corrective_syncs"] = gather_syncs
            else:
                chunk_bytes, gather_syncs = batched_chunk_fetch(
                    graph, gather_nodes)
        stats["n_gather_syncs"] = gather_syncs

        # write phase: pack each written pod's blob (from the layout its
        # assignment keeps, `pod_blob`) and its delta candidate, then put
        # them in batches of at most WRITE_BATCH_BYTES.  Each batch's puts
        # retry transient I/O errors with backoff (retry_policy), resuming
        # after the last pod that landed; puts are idempotent — a pod is
        # content-addressed and the rename is atomic — so a retried step
        # never double-applies.  InjectedCrash (a BaseException) punches
        # through, and only the pods that landed reach the thesaurus.
        with span("save.write", stats, "t_write"):
            n_retries = 0
            # delta-chain eligibility for this save: only the reuse path
            # has a per-pod parent digest AND the soundness proof
            # (assignment reuse + detector mask) that non-patched entries
            # are byte-identical.
            delta_eligible = (self.delta_chains and pods_reused
                              and touched_pods is not None)
            scalar_changed = (set(ginfo.scalar_changed_keys) if ginfo
                              else set())
            chain_depth_max = 0
            t_delta = t_pack = t_put = 0.0
            n_serialized = n_from_layout = 0
            # pods stored, and those of them stored as deltas
            stored: List[int] = []
            stored_delta: List[int] = []
            at = 0
            while at < len(to_write):
                # the batch's entries of `to_write`, their blobs (a delta
                # blob where one is admitted), and (base hex, chain depth)
                # by index of each pod stored as a delta.  Parallel lists,
                # so that packing allocates no container a pod for the
                # cyclic collector to trace.
                batch: List[tuple] = []
                blobs: List[bytes] = []
                deltas: Dict[int, Tuple[str, int]] = {}
                packed: Set[str] = set()          # their digests, for deltas
                with span("save.write.pack") as sp:
                    n_bytes = 0
                    while at < len(to_write) and n_bytes < WRITE_BATCH_BYTES:
                        entry = to_write[at]
                        pid, pod, dig_hex, digest = entry
                        base = (prev_pod_digests.get(pid) if delta_eligible
                                else None)
                        base_hex = (base.hex() if base not in (None, digest)
                                    else None)
                        if base_hex in packed:
                            # its delta base is a pod of this batch: put
                            # the batch first, so the base is in the store
                            break
                        at += 1
                        data, kept = pod_blob(pod, graph, asg, chunk_bytes)
                        n_serialized += 1
                        n_from_layout += kept
                        n_bytes += len(data)
                        if base_hex is not None:
                            with span("save.write.delta") as sd:
                                delta = self._delta_of(
                                    pod, graph, data, base_hex, report.dirty,
                                    scalar_changed)
                            t_delta += sd.seconds
                            if delta is not None:
                                data = delta[0]
                                deltas[len(blobs)] = (base_hex, delta[1])
                        batch.append(entry)
                        blobs.append(data)
                        if delta_eligible:
                            packed.add(dig_hex)
                t_pack += sp.seconds
                with span("save.write.put") as sp:
                    landed, nr = self._put_batch(batch, blobs, deltas)
                t_put += sp.seconds
                n_retries += nr
                for j, fresh in enumerate(landed):
                    if not fresh:
                        aliased += 1              # disk-level synonym
                        continue
                    written += 1
                    pid = batch[j][0]
                    stored.append(pid)
                    if j in deltas:
                        # the manifest records chain structure only for
                        # pods this commit actually stored in delta form
                        # (a dedup hit keeps whatever form the digest
                        # already has).
                        base_hex, depth = deltas[j]
                        pods_meta[pid]["delta_of"] = base_hex
                        stored_delta.append(pid)
                        chain_depth_max = max(chain_depth_max, depth)
            n_delta_pods = len(stored_delta)
            stats["t_write_pack"] = t_pack
            stats["t_write_put"] = t_put
            stats["n_pods_serialized"] = n_serialized
            stats["n_pods_from_layout"] = n_from_layout
            stats["written_chunk_bytes"], stats["clean_written_bytes"] = \
                written_chunk_bytes(graph, asg, report, stored, stored_delta)
        stats["n_retries"] = n_retries
        stats["pods_written"] = written
        stats["pods_aliased"] = aliased
        stats["n_delta_pods"] = n_delta_pods
        stats["t_delta_encode"] = t_delta
        stats["chain_depth_max"] = chain_depth_max

        # commit: the manifest, the refcounts and the refs, as one unit
        with span("save.commit", stats, "t_commit"):
            stats["bytes_written"] = self.store.total_bytes() - bytes_before
            manifest: Dict[str, Any] = {}

            def commit() -> None:
                with self.saver.l_ns:
                    # fencing gate: the refs CAS must not publish a commit
                    # whose lease was reaped or taken over mid-save — a
                    # fenced GC may already have swept what the dead
                    # intent pinned.
                    if lease is not None:
                        self.leases.check(lease)
                    # the manifest put is the data commit point; the refs
                    # CAS in record() is the visibility commit point.  All
                    # three steps are idempotent, so the unit is safe to
                    # retry on transient I/O errors.  The refcount lands
                    # BEFORE the refs CAS: a crash in between leaves a
                    # counted dangling commit — conservative, and exactly
                    # what rebuild() computes.
                    with span("save.commit.manifest", stats,
                              "t_commit_manifest"):
                        if not manifest:
                            manifest.update(
                                time_id=time_id, parent=parent,
                                root_pod=asg.root_pod,
                                page_size=MEMO_PAGE_SIZE,
                                pods={str(pid): meta
                                      for pid, meta in pods_meta.items()},
                                # the save's full chunk-digest table, so a
                                # later delta-aware checkout can prime
                                # change detection without re-hashing
                                chunks=pack_digest_table(report.digests),
                                stats={k: v for k, v in stats.items()
                                       if isinstance(v, (int, float, str))
                                       and k not in SPAN_ONLY_STATS})
                        self.store.put_manifest(time_id, manifest)
                    if self.refcounts is not None:
                        with span("save.commit.refcounts", stats,
                                  "t_commit_refcounts"):
                            coded, whole = self.refcounts.record_commit(
                                time_id, manifest)
                            stats["n_refcount_coded"] = coded
                            stats["n_refcount_whole"] = whole
                    with span("save.commit.refs", stats, "t_commit_refs"):
                        self.versions.record(time_id, parent, branch=branch)

            _, nr = call_with_retries(commit, self.retry_policy)
            stats["n_retries"] = n_retries + nr
        if lease is not None:
            # the commit is now pinned by refs; best-effort intent clear.
            try:
                self.leases.clear_intent(lease)
            except Exception:
                pass
        lin.prev_pods = asg
        lin.prev_graph = graph
        self.save_stats.append(stats)

    # ------------------------------------------------------------------
    # load
    # ------------------------------------------------------------------
    def _open(self, time_id: Optional[TimeID]) -> tuple:
        with self.saver.l_ns:
            if time_id is None:
                tids = self.store.list_time_ids()
                if not tids:
                    raise FileNotFoundError("no checkpoints in store")
                time_id = tids[-1]
            manifest = self.store.get_manifest(time_id)
        memo, digests = open_manifest(manifest)

        def fetch(pod_id: int) -> bytes:
            return self.store.get_pod(digests[pod_id])

        return manifest, Unpodder(memo, fetch, device=self.device)

    def load(self, names: Optional[Set[str]] = None,
             time_id: Optional[TimeID] = None,
             like: Any = None) -> Any:
        """Restore variables as tensors on the instance's device.
        `names=None` loads the full namespace; otherwise only pods
        reachable from the requested variables are read (partial
        loading, §3.1)."""
        manifest, up = self._open(time_id)
        root_pod = manifest["root_pod"]
        root_entry = up.entry(root_pod, 0)
        names_avail = root_entry["m"]["names"]
        out: Dict[str, Any] = {}
        for name, vid in zip(names_avail, root_entry["r"]):
            if names is not None and name not in names:
                continue
            cp, cl = up.resolve(root_pod, vid)
            out[name] = up.value(cp, cl)
        self.last_load_pods = len(up.loaded_pods)
        if like is not None:
            return reflow(like, out)
        return out

    # ------------------------------------------------------------------
    # versioning
    # ------------------------------------------------------------------
    def branch(self, name: str, at: Any = None) -> TimeID:
        """Create branch `name` (at HEAD unless `at` gives a ref/TimeID)
        and switch to it: subsequent saves advance the new branch."""
        self.wait()
        with self.saver.l_ns:
            return self.versions.create_branch(name, at=at)

    def tag(self, name: str, at: Any = None) -> TimeID:
        """Pin a commit under an immutable name (a GC root)."""
        self.wait()
        with self.saver.l_ns:
            return self.versions.create_tag(name, at=at)

    def delete_branch(self, name: str) -> None:
        """Drop a branch ref; its exclusive commits become GC-eligible.
        Drains in-flight saves first (an async commit still targeting the
        branch would otherwise resurrect it).  With refcounts on, the
        orphaned tip is remembered so the next ``gc()`` reclaims it
        incrementally; ``evict_branch`` deletes and reclaims in one step."""
        self.wait()
        with self.saver.l_ns:
            tip = self.versions.branches.get(name)
            self.versions.delete_branch(name)
            if self.refcounts is not None and tip is not None:
                self._gc_backlog.append(tip)

    def checkout(self, ref: Any = None, *, like: Any = None) -> Any:
        """Restore the state of a branch / tag / TimeID, delta-aware.

        Only pods whose digest differs from the live in-memory state are
        read from the store; leaves whose digests all match come back as
        the live tensor objects (shared with the caller's previous state).
        The live bytes are digested first (one fused pass, one fetch), so
        a tensor changed in place since the last save comes from the store;
        afterwards the incremental save pipeline is primed so the next
        `save()` reuses the checked-out assignment and pays one blocking
        fetch.  Moves HEAD (onto the branch, or detached for tags/TimeIDs)
        and returns the restored state (re-flowed into `like` if given).
        Fine-grained stats land in `self.last_checkout_stats`.
        """
        self.wait()
        from ..version import delta_checkout
        dag = self.versions
        tid = dag.resolve(ref)
        if tid is None:
            raise FileNotFoundError("no commit to check out")
        state, stats = delta_checkout(self, tid)
        self.last_checkout_stats = stats
        with self.saver.l_ns:
            if ref is not None:
                dag.set_head(ref)
            self.lineage.head = tid
        if like is not None:
            return reflow(like, state)
        return state

    def log(self, ref: Any = None, limit: Optional[int] = None):
        """First-parent history of a ref (default HEAD), newest first.
        Drains in-flight saves so the newest commit is visible."""
        self.wait()
        return self.versions.log(ref, limit=limit)

    def diff(self, a: Any, b: Any):
        """Pod-granular delta between two refs (see `PodDelta`)."""
        self.wait()
        return self.versions.diff(a, b)

    def gc(self, *, dry_run: bool = False, full: Optional[bool] = None):
        """Reclaim pods/manifests unreachable from branch refs, tags,
        and HEAD.  Drains in-flight saves first, so a pending manifest
        always lands — and roots its pods — before anything is marked.
        Swept digests are pruned from the thesaurus so a future save
        rewrites, not aliases, them.  `dry_run=True` reports the same
        reclaim the real sweep would free, deleting nothing.

        With ``refcounts=True`` the default is the incremental path:
        drain the backlog of `delete_branch` tips through
        `refcount_reclaim`; ``full=True`` forces the mark-and-sweep oracle
        and trues the refcount index up afterwards.  Without refcounts
        every gc is full.
        """
        self.wait()
        from ..version import mark_and_sweep, refcount_reclaim
        if full is None:
            full = self.refcounts is None
        with self.saver.l_ns:
            if not full and self.refcounts is not None:
                stats = refcount_reclaim(self.store, self.versions,
                                         self.refcounts,
                                         list(self._gc_backlog),
                                         extra_roots=(self.lineage.head,),
                                         dry_run=dry_run,
                                         leases=self.leases)
                if not dry_run:
                    self._gc_backlog.clear()
                    if stats.deleted_pod_digests:
                        self.thesaurus.prune(stats.deleted_pod_digests)
                return stats
            stats = mark_and_sweep(self.store, self.versions,
                                   extra_roots=(self.lineage.head,),
                                   dry_run=dry_run,
                                   leases=self.leases)
            if not dry_run:
                self._gc_backlog.clear()
                if stats.deleted_pod_digests:
                    self.thesaurus.prune(stats.deleted_pod_digests)
                if self.refcounts is not None:
                    # the sweep bypassed the index by design (it is the
                    # oracle); reconcile it with the store it just edited.
                    self.refcounts.rebuild()
        return stats

    def evict_branch(self, name: str, *, dry_run: bool = False):
        """Delete branch `name` and reclaim its exclusive commits and
        pods immediately.  Requires ``refcounts=True``; cost scales with
        the branch's delta against surviving history, and what it frees
        is bit-identical to a full mark-and-sweep after the same
        deletion.  ``dry_run=True`` estimates the reclaim without
        touching the ref or the store.  Returns `GCStats`.
        """
        if self.refcounts is None:
            raise RuntimeError("evict_branch requires refcounts=True "
                               "(otherwise: delete_branch + gc)")
        self.wait()
        from ..version import refcount_reclaim
        with self.saver.l_ns:
            # a pool peer may have advanced the branch since we last read
            # refs: evict the CURRENT tip, and fail loudly on a branch a
            # peer already deleted.
            self.versions.sync()
            tip = self.versions.branches.get(name)
            if tip is None:
                raise KeyError(f"unknown branch {name!r}")
            # the live in-memory state pins its own commit (extra_roots)
            # — unless that commit IS the evicted tip, in which case the
            # live incremental state dies with the branch: reset it like
            # a failed save, so the next save rebuilds from scratch.
            lin = self.lineage
            head_root = lin.head if lin.head != tip else None
            if dry_run:
                return refcount_reclaim(self.store, self.versions,
                                        self.refcounts, [tip],
                                        extra_roots=(head_root,),
                                        exclude_refs=(name,),
                                        dry_run=True,
                                        leases=self.leases)
            if lin.head == tip:
                lin.forget(None)
                if lin.graph_cache is not None:
                    lin.graph_cache.invalidate()
            self.versions.delete_branch(name)
            stats = refcount_reclaim(self.store, self.versions,
                                     self.refcounts, [tip],
                                     extra_roots=(head_root,),
                                     leases=self.leases)
            if stats.deleted_pod_digests:
                self.thesaurus.prune(stats.deleted_pod_digests)
        return stats

    def fsck(self, *, deep: bool = False, repair: bool = True):
        """Recovery scan: classify torn saves, roll refs back to the
        newest complete commit, sweep debris.  Drains in-flight saves
        first; afterwards the in-memory DAG and HEAD are re-synced to the
        repaired refs, and swept pod digests are pruned from the
        thesaurus.  Returns the `FsckReport` (also ``self.last_fsck``)."""
        self.wait()
        from ..version import fsck as _fsck
        with self.saver.l_ns:
            report = _fsck(self.store, deep=deep, repair=repair,
                           leases=self.leases)
            if report.swept_pod_digests:
                self.thesaurus.prune(report.swept_pod_digests)
            if repair:
                self.versions.reload()
                self.lineage.head = self.versions.head_commit()
                # a swept torn save may have consumed TimeIDs; never
                # reissue one below an existing manifest.
                existing = self.store.list_time_ids()
                if existing:
                    self._next_time = max(self._next_time,
                                          existing[-1] + 1)
                if self.refcounts is not None:
                    self.refcounts.ensure()
        self.last_fsck = report
        return report


def reflow(like: Any, loaded: Dict[str, Any]) -> Any:
    """Re-flow loaded values into the structure of `like` (so custom
    containers survive a round-trip).

    Tuples are rebuilt positionally; namedtuple-style containers (anything
    exposing `_fields`) are reconstructed with positional-star args, since
    their constructors take fields, not an iterable.
    """
    def walk(template: Any, value: Any) -> Any:
        if isinstance(template, dict):
            return {k: walk(template[k], value[k]) for k in template}
        if isinstance(template, (list, tuple)) and not hasattr(template, "shape"):
            t = type(template)
            vals = [walk(t_i, value[str(i)] if isinstance(value, dict) else value[i])
                    for i, t_i in enumerate(template)]
            if hasattr(template, "_fields"):   # namedtuple-style
                return t(*vals)
            return t(vals)
        return value

    return walk(like, loaded)
