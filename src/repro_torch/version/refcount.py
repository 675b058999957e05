"""Persistent pod refcounts: O(delta) reclaim without a full mark.

Mark-and-sweep (gc.py) is exact but global: every collection walks every
ref, every manifest, and every pod — O(store).  At fleet scale (the
multi-tenant session service, thousands of branches over one shared
store) eviction of ONE session must not pay for the whole store.  This
module keeps the bookkeeping the mark phase would otherwise recompute as
a small persistent index in store meta, maintained through the same
`compare_and_put_meta` CAS every other piece of shared state
(refs, leases, the TimeID counter) already rides on:

    {
      "tids":     [counted commit TimeIDs],
      "counts":   {pod digest hex: #counted manifests referencing it},
      "children": {str(tid): #counted commits whose parent == tid},
      "chains":   {delta digest hex: base digest hex},
    }

  * **counts** mirror the mark set's pod side: a pod is reclaimable
    exactly when no on-disk manifest references it.  Counting manifests
    (not refs) is deliberate — mark-and-sweep deletes a pod only when no
    *live* manifest names it, but a dangling-yet-complete manifest keeps
    its pods until the manifest itself is swept, and the refcount path
    preserves that ordering: commits die first (the walk below), then
    their pods' counts hit zero.
  * **children** are the walk's stop condition: evicting a branch walks
    first-parent from its (now unreferenced) tip and stops at the first
    commit that is still someone's parent, another ref's tip, or a
    protected root — the fork point back into the surviving history.
    The walk therefore touches O(commits exclusive to the branch), never
    O(store).
  * **chains** record the *physical* delta links (`delta_of` manifest
    annotations of freshly delta-stored pods), so the reclaim can
    re-materialize live chain descendants of a doomed base without
    `list_delta_pods()` — the same rescue mark-and-sweep performs, from
    the index instead of a scan.

Maintenance protocol (crash ordering is load-bearing):

  * `record_commit` runs between the manifest put and the refs CAS of
    every save.  A crash in the put→record window leaves a counted=no /
    manifest=yes drift that the fsck rebuild repairs (and flags); a
    crash in the record→refs window leaves a counted dangling commit —
    inflated counts are safe (a pod is kept, never lost), and
    `rebuild()` converges to the same answer because it also counts
    dangling manifests.
  * `refcount_reclaim` applies the whole reclaim plan to the index in
    ONE CAS *after* re-materialization and *before* any deletion: a
    crash after the CAS strands uncounted orphan blobs (debris for a
    full gc / fsck), never a counted-but-deleted pod.
  * Everything self-heals: a torn/corrupt index blob is rebuilt from
    the store inside the next mutation, `fsck` rebuilds it after every
    repair, and `Chipmink.gc(full=True)` rebuilds it after a real
    mark-and-sweep (which bypasses the index by design — it remains the
    oracle the refcount path is tested bit-identical against).

Concurrency: mutations are read-modify-CAS loops (the `LeaseManager`
pattern), so concurrent writers on one store compose.  The *reclaim*
additionally honors the gc lease + sweep fence when the caller runs
multi-writer (intent-pinned tids/digests are excluded exactly like the
mark-and-sweep path); single-process callers (the session service)
serialize reclaim against their own savers instead.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, Iterable, List, Optional, Set

import msgpack

from ..core.lease import Lease, LeaseManager
from ..core.store import BaseStore
from .commit_graph import CommitDAG
from .gc import GCStats, _nbytes_or_zero

REFCOUNTS_META_KEY = "pod_refcounts"

#: CAS attempts for one index mutation before giving up.  Generous: a
#: conflict means another writer made progress, and the index blob is
#: contended by every concurrent save on the store.
MAX_CAS_RETRIES = 64


class RefcountCASError(RuntimeError):
    """An index mutation kept losing the compare-and-swap race."""


def _scan_state(store: BaseStore) -> Dict[str, Any]:
    """The index rebuilt from first principles: every readable manifest
    counts (reachable or dangling — see module docstring), every
    physical delta form contributes a chain link."""
    tids: List[int] = []
    counts: Counter = Counter()
    children: Counter = Counter()
    for tid in store.list_time_ids():
        try:
            m = store.get_manifest(tid)
            digs = {meta["d"] for meta in m.get("pods", {}).values()}
        except Exception:
            continue          # torn manifest: fsck damage, not a count
        tids.append(tid)
        for d in digs:
            counts[d] += 1
        p = m.get("parent")
        if p is not None:
            children[p] += 1
    chains: Dict[str, str] = {}
    for d in store.list_delta_pods():
        try:
            base = store.pod_base(d)
        except (FileNotFoundError, ValueError):
            continue          # broken header: fsck damage
        if base is not None:
            chains[d] = base
    return {"tids": set(tids), "counts": dict(counts),
            "children": dict(children), "chains": chains}


class RefcountIndex:
    """The persistent index over one store.  Cheap to construct; every
    method re-reads the blob, so instances on different `Chipmink`s (or
    processes) sharing a store stay coherent through the CAS."""

    def __init__(self, store: BaseStore, *,
                 max_cas_retries: int = MAX_CAS_RETRIES) -> None:
        self.store = store
        self.max_cas_retries = max_cas_retries
        self._state: Dict[str, Any] = {"tids": set(), "counts": {},
                                       "children": {}, "chains": {}}
        #: set when the last load found no blob / a corrupt blob
        self.missing = True

    # -- encoding ----------------------------------------------------------
    @staticmethod
    def _encode(state: Dict[str, Any]) -> bytes:
        # canonical: every map sorted, so equal logical states encode to
        # equal bytes — `rebuild()` detects drift (and no-ops) by byte
        # comparison, and CAS retries re-encode deterministically.
        return msgpack.packb({
            "tids": sorted(state["tids"]),
            "counts": {d: state["counts"][d]
                       for d in sorted(state["counts"])},
            # msgpack maps are unpacked with strict string keys repo-wide
            "children": {str(t): state["children"][t]
                         for t in sorted(state["children"])},
            "chains": {d: state["chains"][d]
                       for d in sorted(state["chains"])},
        }, use_bin_type=True)

    @staticmethod
    def _decode(blob: Optional[bytes]) -> Optional[Dict[str, Any]]:
        """None for an absent OR corrupt blob — the caller rebuilds."""
        if blob is None:
            return None
        try:
            raw = msgpack.unpackb(blob, raw=False)
            return {
                "tids": set(int(t) for t in raw["tids"]),
                "counts": {str(d): int(n)
                           for d, n in raw["counts"].items()},
                "children": {int(t): int(n)
                             for t, n in raw["children"].items()},
                "chains": {str(d): str(b)
                           for d, b in raw["chains"].items()},
            }
        except Exception:
            return None

    # -- views -------------------------------------------------------------
    @property
    def tids(self) -> Set[int]:
        return self._state["tids"]

    @property
    def counts(self) -> Dict[str, int]:
        return self._state["counts"]

    @property
    def children(self) -> Dict[int, int]:
        return self._state["children"]

    @property
    def chains(self) -> Dict[str, str]:
        return self._state["chains"]

    def refcount(self, digest_hex: str) -> int:
        return self._state["counts"].get(digest_hex, 0)

    def state_snapshot(self) -> Dict[str, Any]:
        """Deep copy of the in-memory state (test/assert helper)."""
        s = self._state
        return {"tids": set(s["tids"]), "counts": dict(s["counts"]),
                "children": dict(s["children"]),
                "chains": dict(s["chains"])}

    # -- persistence -------------------------------------------------------
    def load(self) -> None:
        """Refresh the in-memory view from the store (no mutation)."""
        state = self._decode(self.store.get_meta(REFCOUNTS_META_KEY))
        self.missing = state is None
        if state is not None:
            self._state = state

    def ensure(self) -> bool:
        """Load; rebuild from the store when the blob is absent or
        corrupt (first contact with a pre-refcount store).  Returns
        whether a rebuild ran."""
        self.load()
        if not self.missing:
            return False
        self.rebuild()
        return True

    def rebuild(self) -> bool:
        """Recompute the index from the store and persist it.  Returns
        True when the persisted blob changed (drift existed)."""
        for _ in range(self.max_cas_retries):
            blob = self.store.get_meta(REFCOUNTS_META_KEY)
            state = _scan_state(self.store)
            new = self._encode(state)
            if new == blob:
                self._state = state
                self.missing = False
                return False
            if self.store.compare_and_put_meta(REFCOUNTS_META_KEY, blob,
                                               new):
                self._state = state
                self.missing = False
                return True
        raise RefcountCASError(
            f"refcount rebuild lost {self.max_cas_retries} CAS races")

    def _mutate(self, fn) -> Any:
        """Read-modify-CAS: `fn(state)` must be pure in its input state
        (it reruns against the reloaded blob after a lost race).  A
        missing or corrupt blob is rebuilt from the store first, so
        every mutation self-heals."""
        for _ in range(self.max_cas_retries):
            blob = self.store.get_meta(REFCOUNTS_META_KEY)
            state = self._decode(blob)
            if state is None:
                state = _scan_state(self.store)
            out = fn(state)
            new = self._encode(state)
            if new == blob or self.store.compare_and_put_meta(
                    REFCOUNTS_META_KEY, blob, new):
                self._state = state
                self.missing = False
                return out
        raise RefcountCASError(
            f"refcount mutation lost {self.max_cas_retries} CAS races")

    # -- mutations ---------------------------------------------------------
    def record_commit(self, time_id: int, manifest: Dict[str, Any]) -> None:
        """Count one freshly-put manifest.  Idempotent per TimeID (the
        commit step retries as a unit), so a retried put never
        double-counts."""
        pods = manifest.get("pods", {})
        digests = sorted({meta["d"] for meta in pods.values()})
        links = [(meta["d"], meta["delta_of"]) for meta in pods.values()
                 if "delta_of" in meta]
        parent = manifest.get("parent")

        def fn(state: Dict[str, Any]) -> None:
            if time_id in state["tids"]:
                return
            state["tids"].add(time_id)
            counts = state["counts"]
            for d in digests:
                counts[d] = counts.get(d, 0) + 1
            if parent is not None:
                ch = state["children"]
                ch[parent] = ch.get(parent, 0) + 1
            for d, base in links:
                state["chains"][d] = base

        self._mutate(fn)

    def apply_reclaim(self, dead_tids: Iterable[int],
                      pod_decrements: Dict[str, int],
                      dead_pods: Iterable[str],
                      child_decrements: Dict[int, int],
                      drop_chains: Iterable[str]) -> None:
        """Apply one reclaim plan in a single CAS (see module docstring
        for where this lands in the delete ordering).  A pinned pod
        whose count hits zero keeps a zero entry instead of vanishing —
        the next rebuild trues it up once its manifest lands."""
        dead_tids = list(dead_tids)
        dead_pod_set = set(dead_pods)
        drop_chains = list(drop_chains)

        def fn(state: Dict[str, Any]) -> None:
            state["tids"].difference_update(dead_tids)
            counts = state["counts"]
            for d, n in pod_decrements.items():
                c = counts.get(d, 0) - n
                if c > 0:
                    counts[d] = c
                elif d in dead_pod_set:
                    counts.pop(d, None)
                else:
                    counts[d] = 0          # pinned survivor
            ch = state["children"]
            for t, n in child_decrements.items():
                c = ch.get(t, 0) - n
                if c > 0:
                    ch[t] = c
                else:
                    ch.pop(t, None)
            for d in drop_chains:
                state["chains"].pop(d, None)

        self._mutate(fn)


def _chain_ancestry(chains: Dict[str, str], digest_hex: str) -> List[str]:
    """The transitive base links of one delta pod, cycle-safe."""
    out: List[str] = []
    seen = {digest_hex}
    cur = chains.get(digest_hex)
    while cur is not None and cur not in seen:
        out.append(cur)
        seen.add(cur)
        cur = chains.get(cur)
    return out


def refcount_reclaim(store: BaseStore, dag: CommitDAG, index: RefcountIndex,
                     tips: Iterable[int], *,
                     extra_roots: Iterable[Optional[int]] = (),
                     exclude_refs: Iterable[str] = (),
                     dry_run: bool = False,
                     leases: Optional[LeaseManager] = None) -> GCStats:
    """Reclaim the commits exclusive to `tips` (just-deleted branch tips)
    and every pod whose manifest refcount hits zero — in O(delta of the
    evicted branch), bit-identical to what a full mark-and-sweep of the
    same store would free (the tested contract).

    `tips` are walked first-parent; the walk stops at any commit that is
    another ref's tip, a caller root (`extra_roots`), intent-pinned, or
    still a counted parent (`children` > 0) — the fork point back into
    surviving history.  `exclude_refs` names refs whose tips must NOT
    stop the walk (a `dry_run` eviction estimate passes the branch's own
    name, since the branch still exists).

    Lease mode mirrors gc.py: the reclaim runs under the exclusive gc
    lease with the sweep fence up, and never deletes anything a live
    writer's save intent pins.  Ordering on the store is the same as
    mark-and-sweep — re-materialize, then manifests, then pods — with
    the index CAS landing between remat and the first delete.
    """
    stats = GCStats(dry_run=dry_run)
    gc_lease: Optional[Lease] = None
    if leases is not None and not dry_run:
        gc_lease = leases.acquire_gc()
        stats.gc_fence = gc_lease.fence
    try:
        # fresh refs: a peer's new branch tip must stop the walk.
        dag.sync()
        index.load()
        if index.missing:
            index.rebuild()

        pin_tids: Set[int] = set()
        pin_digs: Set[str] = set()
        if gc_lease is not None:
            # fence up BEFORE the walk: intents registered later observe
            # "sweep" and wait; earlier ones are in the snapshot.
            pin_tids, pin_digs = leases.begin_sweep(gc_lease)
        elif leases is not None:
            pin_tids, pin_digs = leases.live_intents()

        excluded = set(exclude_refs)
        with dag._lock:
            stop: Set[int] = {t for n, t in dag.branches.items()
                              if n not in excluded}
            stop |= set(dag.tags.values())
            head = dag.head_commit()
        if head is not None:
            stop.add(head)
        stop.update(t for t in extra_roots if t is not None)
        stop |= pin_tids

        # ---- walk: commits exclusive to the evicted tips ---------------
        children = dict(index.children)
        child_dec: Counter = Counter()
        dead_tids: List[int] = []
        dead_tid_set: Set[int] = set()
        manifests: Dict[int, Dict[str, Any]] = {}
        for tip in tips:
            cur: Optional[int] = tip
            while (cur is not None and cur not in stop
                   and cur not in dead_tid_set
                   and children.get(cur, 0) <= 0):
                try:
                    m = store.get_manifest(cur)
                except (KeyError, FileNotFoundError):
                    break          # already swept (crash debris)
                manifests[cur] = m
                dead_tids.append(cur)
                dead_tid_set.add(cur)
                parent = m.get("parent")
                if parent is not None:
                    children[parent] = children.get(parent, 0) - 1
                    child_dec[parent] += 1
                cur = parent

        # ---- pod plan: decrement, collect zeros ------------------------
        pod_dec: Counter = Counter()
        for tid in dead_tids:
            for d in {meta["d"]
                      for meta in manifests[tid].get("pods", {}).values()}:
                pod_dec[d] += 1
        counts = dict(index.counts)
        dead_pods: List[str] = []
        n_pods_pinned = 0
        for d, n in pod_dec.items():
            counts[d] = counts.get(d, 0) - n
            if counts[d] <= 0:
                if d in pin_digs:
                    n_pods_pinned += 1
                else:
                    dead_pods.append(d)
        dead_pod_set = set(dead_pods)
        stats.n_commits_pinned = sum(1 for t in tips if t in pin_tids)
        stats.n_pods_pinned = n_pods_pinned

        # ---- rescue plan: same rule as gc._chain_rescues — any delta
        # pod outside the dead set whose chain crosses a dead link is
        # re-materialized (conservative past a base that is itself being
        # rescued, exactly like the mark-and-sweep oracle).
        chains = index.chains
        remat = sorted(
            d for d in chains
            if d not in dead_pod_set
            and any(link in dead_pod_set
                    for link in _chain_ancestry(chains, d))
            and store.has_pod(d))
        drop_chains = [d for d in chains
                       if d in dead_pod_set] + remat

        stats.n_commits_deleted = len(dead_tids)
        stats.n_pods_deleted = len(dead_pods)
        stats.deleted_pod_digests = dead_pods
        stats.n_commits_live = len(index.tids) - len(dead_tids)
        stats.n_pods_live = len(index.counts) - len(dead_pods)

        if dry_run:
            stats.manifest_bytes_reclaimed = sum(
                _nbytes_or_zero(store.manifest_nbytes, t)
                for t in dead_tids)
            stats.pod_bytes_reclaimed = sum(
                _nbytes_or_zero(store.pod_nbytes, d) for d in dead_pods)
            for d in remat:
                stats.n_pods_rematerialized += 1
                stats.remat_bytes_freed += _nbytes_or_zero(
                    store.pod_nbytes, d)
                stats.remat_bytes_written += _nbytes_or_zero(
                    store.pod_whole_nbytes, d)
            return stats

        # ---- execute: remat → index CAS → manifests → pods -------------
        for d in remat:
            stats.remat_bytes_freed += _nbytes_or_zero(store.pod_nbytes, d)
            stats.remat_bytes_written += store.rematerialize_pod(d)
            stats.n_pods_rematerialized += 1
        index.apply_reclaim(dead_tids, dict(pod_dec), dead_pods,
                            dict(child_dec), drop_chains)
        for tid in dead_tids:
            stats.manifest_bytes_reclaimed += store.delete_manifest(tid)
        for d in dead_pods:
            stats.pod_bytes_reclaimed += store.delete_pod(d)
        dag.forget(dead_tids)
        if dead_tids and store.head() in dead_tid_set:
            store.repair_head()
        return stats
    finally:
        if gc_lease is not None:
            try:
                leases.end_sweep(gc_lease)
                leases.release(gc_lease)
            except Exception:
                pass
