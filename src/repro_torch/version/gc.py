"""Mark-and-sweep pod GC over the commit DAG.

Content-addressed dedup makes the store append-only: abandoned
exploration branches, rebased fine-tunes, and detached commits keep their
pods forever.  "To Store or Not to Store" frames the tradeoff — storage
is only worth paying for states someone can still reach.  The collector
realizes that over refs:

  * **mark** — live commits are everything reachable (by parent pointers)
    from any branch tip, tag, or HEAD, plus caller-supplied extra roots
    (`Chipmink.gc` passes its in-memory HEAD so the state the next save
    will delta against is never collected).  Live pod digests are the
    union of the live manifests' pod tables.
  * **fence** (lease mode) — with a `LeaseManager` the collector holds
    the exclusive **gc lease** across mark→fence→validate→sweep:
    `begin_sweep` flips the lease blob's gc phase to "sweep" via CAS
    and returns, atomically from the replaced blob, every tid/digest
    pinned by a live writer's *save intent* (pods a concurrent save has
    written or will dedup against but whose manifest/refs have not
    landed).  Those are subtracted from the dead sets before anything
    is deleted; intent registrations racing the phase flip either land
    first (and are in the snapshot) or observe "sweep" and wait it out
    (core/lease.py has the full interleaving argument).  A collector
    whose lease expired is fenced out by the same CAS — `LeaseLost`
    aborts before any delete.
  * **validate** — after the fence is up, a no-op compare-and-swap on
    the refs blob proves refs did not move since the mark read them.
    If a concurrent writer advanced a ref mid-mark (a commit the mark
    set does not cover), the sweep would delete live data — instead the
    collector drops the fence, reloads refs, and re-marks, up to
    `MAX_MARK_RETRIES` times.  The fence-then-validate order is what
    makes the pair airtight: a commit published after the mark either
    moved refs before the fence (validate fails → re-mark) or still
    holds its intent at the fence snapshot (pinned) — intents clear
    only after the refs CAS, so there is no in-between.  Without a
    manager the single-writer behavior is unchanged: safe against ref movement,
    single-writer assumed for the final window.
  * **re-materialize** — a live pod stored in delta form whose chain
    crosses a doomed base would become unreadable after the sweep, so
    before anything is deleted every such descendant is rewritten whole
    (`store.rematerialize_pod`: whole form first, then the delta form
    dropped — crash-safe at every point, see core/store.py).  The
    ordering re-materialize → manifests → pods is load-bearing: a crash
    mid-remat leaves all chains intact (nothing deleted yet), and a
    crash mid-sweep can only strand already-whole pods.
  * **sweep** — every manifest of a dead commit and every pod digest
    outside the mark set (and outside the pinned sets) is deleted.
    Order matters for crash safety on the file backend: manifests are
    deleted *first*, so an interrupted sweep can never leave a manifest
    pointing at a vanished pod — only unreferenced pods that the next
    sweep re-collects.  The sweeper's crash is also covered: a dead
    holder's lease expires, a peer (or fsck) reaps it, and the stuck
    "sweep" phase resets.

`dry_run=True` performs the full mark and measures the sweep without
deleting; its byte estimate is computed from the same per-object sizes
the real sweep frees, so estimate == actual by construction (an object
that vanished since the mark counts 0 in both).  Re-materialization is
estimated the same way: the dry run computes the identical rescue set
and charges `pod_whole_nbytes` (the exact size the real remat writes)
against the delta bytes it frees, so `bytes_reclaimed` — reclaim *net*
of re-materialization — matches the real sweep exactly.

The caller must quiesce in-flight saves first (a pending manifest is
invisible to the mark phase until it lands); `Chipmink.gc` drains its
async pipeline before calling in here, and must afterwards prune swept
digests from the thesaurus so future saves rewrite — not alias — them.

Relationship to refcount GC (version/refcount.py)
-------------------------------------------------
Mark-and-sweep is O(store) per collection; the multi-tenant eviction
path (`Chipmink.evict_branch`, the sessions layer) instead maintains a
persistent refcount index at commit time and reclaims dead branch tips
in O(branch delta) via `refcount_reclaim`.  The contract between the
two: **for the same dead tips, refcount reclaim frees the bit-identical
set of commits and pod digests this collector would** (including the
same delta-chain rescues) — asserted in the test suite with this
collector as the oracle.  Mark-and-sweep stays authoritative where
refcounts cannot reach: `Chipmink.gc(full=True)` for garbage produced
outside the delete_branch/evict path, and fsck-time repair, both of
which rebuild the index afterwards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Set

from ..core.lease import Lease, LeaseManager
from ..core.store import BaseStore
from .commit_graph import REFS_META_KEY, CommitDAG

#: how many times the collector re-marks after catching refs moving
#: underneath it before giving up.
MAX_MARK_RETRIES = 4


@dataclasses.dataclass
class GCStats:
    dry_run: bool
    n_commits_live: int = 0
    n_commits_deleted: int = 0
    n_pods_live: int = 0
    n_pods_deleted: int = 0
    pod_bytes_reclaimed: int = 0
    manifest_bytes_reclaimed: int = 0
    n_mark_restarts: int = 0
    # lease mode: in-flight commits/pods pinned by live save intents,
    # and the fencing token the sweep ran under (None = no lease).
    n_commits_pinned: int = 0
    n_pods_pinned: int = 0
    gc_fence: Optional[int] = None
    # delta-chain rescue: live descendants of a swept base rewritten whole
    n_pods_rematerialized: int = 0
    remat_bytes_written: int = 0   # whole blobs written by the rescue
    remat_bytes_freed: int = 0     # delta blobs the rescue replaced
    deleted_pod_digests: List[str] = dataclasses.field(default_factory=list)

    @property
    def bytes_reclaimed(self) -> int:
        """Net reclaim: deleted bytes minus the re-materialization cost
        (whole blobs written in place of freed delta blobs)."""
        return (self.pod_bytes_reclaimed + self.manifest_bytes_reclaimed
                + self.remat_bytes_freed - self.remat_bytes_written)

    def as_dict(self) -> Dict[str, Any]:
        d = {k: v for k, v in self.__dict__.items()
             if k != "deleted_pod_digests"}
        d["bytes_reclaimed"] = self.bytes_reclaimed
        return d


def _nbytes_or_zero(fn: Callable[[Any], int], key: Any) -> int:
    try:
        return fn(key)
    except FileNotFoundError:
        return 0


def mark_and_sweep(store: BaseStore, dag: CommitDAG, *,
                   extra_roots: Iterable[Optional[int]] = (),
                   dry_run: bool = False,
                   leases: Optional[LeaseManager] = None,
                   _after_mark: Optional[Callable[[], None]] = None
                   ) -> GCStats:
    """Collect pods and manifests unreachable from the DAG's refs.

    With `leases`, the collection runs under the exclusive gc lease and
    the sweep fence (see module docstring): raises `LeaseHeld` while
    another live collector holds the lease, takes over an expired one,
    and never deletes anything pinned by a live writer's save intent.
    Dry runs acquire nothing (read-only) but subtract the currently
    live intents so the estimate matches what a real sweep would free.

    `_after_mark` is a test seam: called between mark and the refs CAS
    validation, where a concurrent ref movement must trigger a re-mark.
    """
    stats = GCStats(dry_run=dry_run)

    gc_lease: Optional[Lease] = None
    if leases is not None and not dry_run:
        gc_lease = leases.acquire_gc()     # LeaseHeld / takeover inside
        stats.gc_fence = gc_lease.fence
    try:
        for attempt in range(MAX_MARK_RETRIES + 1):
            if gc_lease is not None:
                leases.renew(gc_lease)     # LeaseLost fences a dead mark
            refs_blob = store.get_meta(REFS_META_KEY)
            # cross-process soundness: the validate CAS below only proves
            # refs didn't move DURING the mark — the mark itself must run
            # against the current blob, not this DAG's possibly-stale
            # in-memory copy (a peer's branch the mark misses would be
            # swept).  sync() re-reads refs without moving the caller's
            # checkout.
            dag.sync()
            dag.refresh()

            # mark — missing_ok: a walk may cross a manifest an earlier
            # sweep reclaimed (an intent-pinned in-flight commit survives
            # its already-dead ancestors); stop there instead of crashing.
            live_tids = dag.live_commits(extra_roots, missing_ok=True)
            live_digests = dag.reachable_digests(extra_roots,
                                                 missing_ok=True)
            stats.n_commits_live = len(live_tids)
            stats.n_pods_live = len(live_digests)

            dead_tids = [t for t in store.list_time_ids()
                         if t not in live_tids]
            dead_pods = [d for d in store.list_pods()
                         if d not in live_digests]

            if dry_run:
                if leases is not None:
                    pin_tids, pin_digs = leases.live_intents()
                    dead_tids, dead_pods = _unpin(stats, dead_tids,
                                                  dead_pods, pin_tids,
                                                  pin_digs)
                stats.n_commits_deleted = len(dead_tids)
                stats.n_pods_deleted = len(dead_pods)
                stats.deleted_pod_digests = dead_pods
                stats.manifest_bytes_reclaimed = sum(
                    _nbytes_or_zero(store.manifest_nbytes, t)
                    for t in dead_tids)
                stats.pod_bytes_reclaimed = sum(
                    _nbytes_or_zero(store.pod_nbytes, d)
                    for d in dead_pods)
                # same rescue set the real sweep would re-materialize;
                # pod_whole_nbytes is the exact size the real remat
                # writes, so the net estimate equals the actual reclaim.
                for d in _chain_rescues(store, dead_pods):
                    stats.n_pods_rematerialized += 1
                    stats.remat_bytes_freed += _nbytes_or_zero(
                        store.pod_nbytes, d)
                    stats.remat_bytes_written += _nbytes_or_zero(
                        store.pod_whole_nbytes, d)
                return stats

            if _after_mark is not None:
                _after_mark()

            # fence FIRST, validate SECOND — the order is load-bearing.
            # begin_sweep flips the phase to "sweep" (new intents now
            # wait) and snapshots everything a live intent pins,
            # atomically with the flip.  Only then does the no-op CAS
            # prove the refs blob is still the one the mark ran against.
            # A writer that commits after the mark either (a) moved refs
            # before the fence went up — the validate CAS fails and we
            # re-mark — or (b) still holds its intent at the snapshot
            # (intents clear only after the refs CAS) and is pinned.
            # Validating before fencing leaves a hole: commit + clear
            # between the two steps escapes both.
            pin_tids: Set[int] = set()
            pin_digs: Set[str] = set()
            if gc_lease is not None:
                pin_tids, pin_digs = leases.begin_sweep(gc_lease)
            if refs_blob is None or store.compare_and_put_meta(
                    REFS_META_KEY, refs_blob, refs_blob):
                break
            if gc_lease is not None:
                leases.end_sweep(gc_lease)     # drop the fence, re-mark
            stats.n_mark_restarts += 1
            dag.sync()
        else:
            raise RuntimeError(
                f"gc: refs moved during {MAX_MARK_RETRIES + 1} "
                "consecutive mark phases; aborting the sweep (quiesce "
                "writers first)")

        # subtract everything a live writer's intent pinned at the fence
        if gc_lease is not None:
            dead_tids, dead_pods = _unpin(stats, dead_tids, dead_pods,
                                          pin_tids, pin_digs)
        stats.n_commits_deleted = len(dead_tids)
        stats.n_pods_deleted = len(dead_pods)
        stats.deleted_pod_digests = dead_pods

        # re-materialize BEFORE any deletion: live delta descendants of a
        # doomed base are rewritten whole while every chain link still
        # exists (crash anywhere in this loop leaves all data readable).
        for d in _chain_rescues(store, dead_pods):
            stats.remat_bytes_freed += _nbytes_or_zero(store.pod_nbytes, d)
            stats.remat_bytes_written += store.rematerialize_pod(d)
            stats.n_pods_rematerialized += 1

        # sweep: manifests first (crash-safe ordering — module docstring)
        for tid in dead_tids:
            stats.manifest_bytes_reclaimed += store.delete_manifest(tid)
        for dig in dead_pods:
            stats.pod_bytes_reclaimed += store.delete_pod(dig)
        dag.forget(dead_tids)
        # the legacy HEAD pointer may name a commit this sweep just
        # reclaimed; refresh it so a later fsck finds no damage.  Only
        # when it actually points at a dead tid — an unconditional
        # rewrite could regress a concurrent writer's newer HEAD.
        if dead_tids and store.head() in set(dead_tids):
            store.repair_head()
        return stats
    finally:
        if gc_lease is not None:
            try:
                leases.end_sweep(gc_lease)
                leases.release(gc_lease)
            except Exception:
                # fenced out / store down: the lease expires on its own
                # and a peer reaps the stuck phase — never mask the
                # original error with cleanup noise.
                pass


def _chain_rescues(store: BaseStore, dead_pods: List[str]) -> List[str]:
    """Live delta-stored pods whose chain crosses a doomed base — the
    set the sweep must re-materialize to stay readable.  An already
    broken or cyclic chain is skipped (nothing to resolve from; that is
    fsck damage, not GC work)."""
    dead = set(dead_pods)
    out: List[str] = []
    for d in store.list_delta_pods():
        if d in dead:
            continue
        try:
            chain = store.pod_chain(d)
        except (FileNotFoundError, ValueError):
            continue
        if any(link in dead for link in chain[1:]):
            out.append(d)
    return out


def _unpin(stats: GCStats, dead_tids: List[int], dead_pods: List[str],
           pin_tids, pin_digs) -> tuple:
    """Subtract intent-pinned commits/pods from the dead sets."""
    kept_t = [t for t in dead_tids if t not in pin_tids]
    kept_p = [d for d in dead_pods if d not in pin_digs]
    stats.n_commits_pinned = len(dead_tids) - len(kept_t)
    stats.n_pods_pinned = len(dead_pods) - len(kept_p)
    return kept_t, kept_p
