"""Commit DAG over manifests: branch refs, tags, HEAD, lineage, pod diffs.

Every `Chipmink.save` is a *commit*: a manifest keyed by TimeID carrying a
parent pointer.  The manifests therefore already form a DAG on disk; this
module gives it the version-control surface the paper's exploration story
needs (branch a fine-tune, time-travel back, fork again):

  * **refs** — named branches (a ref that advances with each save on it),
    tags (frozen refs), and HEAD (the current branch, or a detached
    TimeID).  Refs are persisted as a small msgpack blob through the
    store's metadata interface, atomically on the file backend, so a
    reopened store resumes exactly where it left off.  Every mutation
    lands via `compare_and_put_meta` — an atomic compare-and-swap keyed
    on the previously observed blob — so a concurrent writer (another
    process on the same store) or a GC sweeper can never silently
    clobber a ref: a losing writer reloads the winner's refs, re-applies
    its own mutation on top (refs-level rebase), and retries.  A corrupt
    refs blob (torn write on a non-atomic backend, bitrot) is tolerated
    by rebuilding refs from the manifests (`refs_recovered` flags it;
    fsck reports it).
  * **lineage** — `ancestors`, `children`, `merge_base`, and `log`
    (first-parent walk, newest first), answered from a parent-pointer
    cache filled lazily from manifests.
  * **pod-granular diff** — `diff(a, b)` compares the pod digest sets of
    two manifests: digests only in a, only in b, and shared, with stored
    byte totals.  This is the unit of work for delta-aware checkout
    (fetch only `only_b`) and the observability story for dedup across
    branches.

The DAG never mutates manifests; it only reads them and owns the refs
blob.  All mutation entry points are serialized by an internal lock so an
overlapped async save (which records its commit from the podding thread)
cannot race a caller-side `branch`/`tag`/`checkout`.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Set, Union

import msgpack

from ..core.faults import RetryPolicy
from ..core.store import BaseStore

REFS_META_KEY = "refs"
DEFAULT_BRANCH = "main"
#: default CAS attempts before giving up on a refs mutation.  A single
#: writer never conflicts; N writers make progress because every
#: conflict means someone else's mutation landed (lock-free progress
#: guarantee) — but an N-writer fleet hammering one refs blob CAN lose
#: more than 8 races honestly, so the budget is per-DAG configurable
#: (``max_cas_retries``) and losers back off with jitter
#: (``cas_backoff``) instead of retrying in lockstep.
MAX_CAS_RETRIES = 8
#: default loser backoff: jittered exponential so N losers of the same
#: race don't re-collide on the next attempt (reuses `RetryPolicy`'s
#: delay schedule; the first couple of retries are nearly free).
DEFAULT_CAS_BACKOFF = RetryPolicy(backoff_s=0.0005, multiplier=2.0,
                                  jitter=0.5)

Ref = Union[str, int]


class RefsCASError(RuntimeError):
    """A refs mutation kept losing the compare-and-swap race."""


@dataclasses.dataclass
class PodDelta:
    """Pod-granular difference between two commits."""

    tid_a: int
    tid_b: int
    only_a: Set[str]
    only_b: Set[str]
    shared: Set[str]
    bytes_only_a: int = 0
    bytes_only_b: int = 0
    bytes_shared: int = 0

    @property
    def n_shared(self) -> int:
        return len(self.shared)


class CommitDAG:
    """Persisted commit graph + refs over a content-addressed store."""

    def __init__(self, store: BaseStore,
                 default_branch: str = DEFAULT_BRANCH, *,
                 max_cas_retries: Optional[int] = None,
                 cas_backoff: Optional[RetryPolicy] = None) -> None:
        self.store = store
        self.default_branch = default_branch
        self.max_cas_retries = (MAX_CAS_RETRIES if max_cas_retries is None
                                else int(max_cas_retries))
        self.cas_backoff = (DEFAULT_CAS_BACKOFF if cas_backoff is None
                            else cas_backoff)
        #: cumulative refs CAS races lost (and rebased) by this DAG —
        #: the contention benchmark's lost-race metric.
        self.n_cas_races = 0
        self.branches: Dict[str, int] = {}
        self.tags: Dict[str, int] = {}
        #: current branch name, or None when HEAD is detached
        self.head_branch: Optional[str] = default_branch
        #: detached HEAD commit (meaningful only when head_branch is None)
        self.detached: Optional[int] = None
        self._parents: Dict[int, Optional[int]] = {}
        self._lock = threading.RLock()
        #: last refs blob observed in the store — the CAS expected-old.
        self._refs_blob: Optional[bytes] = None
        #: set when the persisted refs blob was corrupt and refs were
        #: rebuilt from manifests (fsck reports this condition).
        self.refs_recovered = False
        self._load_refs()

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def _load_refs(self) -> None:
        """(Re)read refs from the store; bootstrap/rebuild when the blob
        is absent or corrupt."""
        self.branches = {}
        self.tags = {}
        self.head_branch = self.default_branch
        self.detached = None
        blob = self.store.get_meta(REFS_META_KEY)
        self._refs_blob = blob
        if blob is None:
            self._bootstrap_refs()
            return
        try:
            refs = msgpack.unpackb(blob, raw=False)
            branches = {str(k): int(v) for k, v in refs["branches"].items()}
            tags = {str(k): int(v) for k, v in refs["tags"].items()}
            head_branch = refs["head_branch"]
            detached = refs["detached"]
        except Exception:
            # torn/corrupt refs blob (non-atomic backend, bitrot): the
            # manifests are the durable truth — rebuild refs from them so
            # every commit stays reachable.  _refs_blob keeps the corrupt
            # bytes as the CAS base, so the rebuild replaces exactly what
            # we read and a concurrent repair cannot be clobbered.
            self.refs_recovered = True
            self._bootstrap_refs()
            return
        self.branches = branches
        self.tags = tags
        self.head_branch = head_branch
        self.detached = detached

    def _bootstrap_refs(self) -> None:
        """First contact with a pre-versioning store (or a store whose
        refs blob was torn): manifests exist but no usable refs blob
        does.  Every commit must stay reachable — GC with an empty mark
        set would otherwise sweep the entire store — so every childless
        tip becomes a branch: the newest tip takes the default branch
        name, the rest get ``tip-<TimeID>`` (deletable by the user before
        a gc that should actually reclaim them)."""
        tids = self.store.list_time_ids()
        if not tids:
            return
        self.refresh()
        with_children = {p for p in self._parents.values() if p is not None}
        tips = [t for t in tids if t not in with_children]
        newest = max(tips) if tips else tids[-1]
        self.branches[self.default_branch] = newest
        for t in tips:
            if t != newest:
                self.branches[f"tip-{t}"] = t
        self.head_branch = self.default_branch
        blob = self._pack_refs()
        if self.store.compare_and_put_meta(REFS_META_KEY, self._refs_blob,
                                           blob):
            self._refs_blob = blob
        else:
            # another opener bootstrapped first — adopt its result.
            self._load_refs()

    def _pack_refs(self) -> bytes:
        return msgpack.packb({
            "branches": self.branches,
            "tags": self.tags,
            "head_branch": self.head_branch,
            "detached": self.detached,
        }, use_bin_type=True)

    def _commit_refs(self, mutate) -> Any:
        """Apply `mutate` (a closure over self's in-memory refs) and land
        the result via compare-and-swap against the last observed blob.

        The commit protocol's step 3 (pods → manifest → **refs**): the
        CAS makes the ref advance atomic with respect to every other
        writer and the GC sweeper.  On conflict the winner's refs are
        reloaded and `mutate` re-applies on top — a refs-level rebase —
        so no concurrent mutation is ever silently lost.  `mutate` must
        therefore be re-runnable: validation (unknown ref, duplicate
        branch) re-executes against the reloaded state, which is exactly
        the semantics a lock would have given.
        """
        for attempt in range(self.max_cas_retries):
            local_head, local_detached = self.head_branch, self.detached
            out = mutate()
            blob = self._pack_refs()
            if blob == self._refs_blob:
                return out                   # no-op mutation
            if self.store.compare_and_put_meta(REFS_META_KEY,
                                               self._refs_blob, blob):
                self._refs_blob = blob
                return out
            # lost the race: back off with jitter (losers of the same
            # conflict must not retry in lockstep), then rebase.
            self.n_cas_races += 1
            if attempt:
                time.sleep(self.cas_backoff.delay(attempt - 1))
            self._load_refs()
            # the rebase keeps THIS writer's checkout: the blob's
            # head_branch is whichever peer wrote last, and adopting it
            # would make the retried mutation advance the *peer's*
            # branch with our commit.  HEAD in the blob stays
            # last-writer-wins (it only seeds a fresh open).
            self.head_branch, self.detached = local_head, local_detached
        raise RefsCASError(
            f"refs CAS lost {self.max_cas_retries} races in a row — "
            "a stuck writer or a livelocked store?  (Raise "
            "max_cas_retries for heavily contended stores.)")

    def reload(self) -> None:
        """Re-read refs and drop the parent cache.  For callers that know
        the store changed underneath them: after fsck repaired refs, or
        to observe another process's commits."""
        with self._lock:
            self._parents = {}
            self._load_refs()

    def sync(self) -> None:
        """Re-read refs from the store, keeping THIS process's checkout
        (head_branch / detached) — the cross-process refresh: GC's mark
        phase must see every peer's branch tips, but must not move the
        local HEAD onto whichever branch a peer touched last.  The
        parent cache survives (commits are immutable; `refresh` fills in
        new ones)."""
        with self._lock:
            local_head, local_detached = self.head_branch, self.detached
            self._load_refs()
            self.head_branch, self.detached = local_head, local_detached

    def refresh(self) -> None:
        """Fill the parent cache from every manifest in the store.  A
        manifest listed but gone by the time it's read (a peer swept it
        between the two calls) is skipped, not an error."""
        with self._lock:
            for tid in self.store.list_time_ids():
                if tid not in self._parents:
                    try:
                        m = self.store.get_manifest(tid)
                    except (KeyError, FileNotFoundError):
                        continue
                    self._parents[tid] = m.get("parent")

    # ------------------------------------------------------------------
    # refs
    # ------------------------------------------------------------------
    def resolve(self, ref: Optional[Ref]) -> Optional[int]:
        """Ref → TimeID: branch name, tag name, literal TimeID, or None
        (= current HEAD commit)."""
        with self._lock:
            if ref is None:
                return self.head_commit()
            if isinstance(ref, int):
                # validate here so a bad TimeID fails uniformly instead of
                # surfacing a backend-specific error from a later fetch
                if ref not in self._parents \
                        and ref not in self.store.list_time_ids():
                    raise KeyError(f"unknown commit TimeID {ref}")
                return ref
            if ref in self.branches:
                return self.branches[ref]
            if ref in self.tags:
                return self.tags[ref]
            raise KeyError(f"unknown ref {ref!r}")

    def head_commit(self) -> Optional[int]:
        with self._lock:
            if self.head_branch is not None:
                return self.branches.get(self.head_branch)
            return self.detached

    def record(self, time_id: int, parent: Optional[int],
               branch: Optional[str] = None) -> None:
        """Register a fresh commit and advance a ref onto it.

        Default (`branch=None`): HEAD advances.  On a branch, the branch
        ref advances; detached HEAD just moves (the commit is reachable
        only through HEAD until branched/tagged — exactly git's
        detached-commit semantics, and exactly what GC protects via the
        HEAD root).

        With an explicit `branch`, THAT ref is created-or-advanced and
        HEAD is left alone — the multi-tenant path: a session service
        commits onto ``sessions/<id>`` refs without ever moving its own
        checkout, so thousands of sessions can interleave saves through
        one instance.
        """
        with self._lock:
            def mut() -> None:
                self._parents[time_id] = parent
                if branch is not None:
                    self.branches[branch] = time_id
                elif self.head_branch is not None:
                    self.branches[self.head_branch] = time_id
                else:
                    self.detached = time_id
            self._commit_refs(mut)

    def create_branch(self, name: str, at: Optional[Ref] = None,
                      switch: bool = True) -> int:
        with self._lock:
            def mut() -> int:
                if name in self.branches:
                    raise ValueError(f"branch {name!r} already exists")
                tid = self.resolve(at)
                if tid is None:
                    raise ValueError(
                        "cannot branch: no commit to branch from")
                self.branches[name] = tid
                if switch:
                    self.head_branch = name
                    self.detached = None
                return tid
            return self._commit_refs(mut)

    def delete_branch(self, name: str) -> None:
        with self._lock:
            def mut() -> None:
                if name == self.head_branch:
                    raise ValueError(
                        f"cannot delete the current branch {name!r}")
                del self.branches[name]
            self._commit_refs(mut)

    def branches_under(self, prefix: str) -> Dict[str, int]:
        """Branches whose name starts with `prefix` (namespace listing —
        e.g. ``sessions/`` for the session service's live set)."""
        with self._lock:
            return {n: t for n, t in self.branches.items()
                    if n.startswith(prefix)}

    def create_tag(self, name: str, at: Optional[Ref] = None) -> int:
        with self._lock:
            def mut() -> int:
                tid = self.resolve(at)
                if tid is None:
                    raise ValueError("cannot tag: no commit to tag")
                self.tags[name] = tid
                return tid
            return self._commit_refs(mut)

    def delete_tag(self, name: str) -> None:
        with self._lock:
            def mut() -> None:
                del self.tags[name]
            self._commit_refs(mut)

    def set_head(self, ref: Ref) -> int:
        """Move HEAD: onto a branch (by name) or detached (tag/TimeID)."""
        with self._lock:
            def mut() -> int:
                if isinstance(ref, str) and ref in self.branches:
                    self.head_branch = ref
                    self.detached = None
                    return self.branches[ref]
                tid = self.resolve(ref)
                self.head_branch = None
                self.detached = tid
                return tid
            return self._commit_refs(mut)

    # ------------------------------------------------------------------
    # lineage
    # ------------------------------------------------------------------
    def parent(self, tid: int, *, missing_ok: bool = False) -> Optional[int]:
        """Parent TimeID of `tid` (None at the root).  With `missing_ok`
        a missing manifest reads as parentless instead of raising — the
        GC mark needs this: an intent-pinned in-flight commit can
        outlive a sweep that reclaimed its (already-dead) ancestors, so
        a later walk from it must stop, not crash.  The miss is NOT
        cached: the manifest may simply not be written yet, and a
        cached None would hide its real parent from the next mark."""
        with self._lock:
            if tid not in self._parents:
                try:
                    m = self.store.get_manifest(tid)
                except (KeyError, FileNotFoundError):
                    if not missing_ok:
                        raise
                    return None
                self._parents[tid] = m.get("parent")
            return self._parents[tid]

    def ancestors(self, tid: int) -> List[int]:
        """The first-parent chain from `tid` back to the root, inclusive."""
        out: List[int] = []
        cur: Optional[int] = tid
        while cur is not None:
            out.append(cur)
            cur = self.parent(cur)
        return out

    def children(self, tid: int) -> List[int]:
        with self._lock:
            self.refresh()
            return sorted(t for t, p in self._parents.items() if p == tid)

    def merge_base(self, a: Ref, b: Ref) -> Optional[int]:
        """Nearest common ancestor of two refs (None if disjoint)."""
        ta, tb = self.resolve(a), self.resolve(b)
        if ta is None or tb is None:
            return None
        seen = set(self.ancestors(ta))
        cur: Optional[int] = tb
        while cur is not None:
            if cur in seen:
                return cur
            cur = self.parent(cur)
        return None

    def log(self, ref: Optional[Ref] = None,
            limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """First-parent history of a ref, newest first, with save stats."""
        tid = self.resolve(ref)
        if tid is None:
            return []
        tips = {t: n for n, t in self.branches.items()}
        tagged = {t: n for n, t in self.tags.items()}
        out: List[Dict[str, Any]] = []
        for t in self.ancestors(tid):
            if limit is not None and len(out) >= limit:
                break
            m = self.store.get_manifest(t)
            stats = m.get("stats", {})
            out.append({
                "time_id": t,
                "parent": m.get("parent"),
                "branch": tips.get(t),
                "tag": tagged.get(t),
                "n_pods": len(m.get("pods", {})),
                "pods_written": stats.get("pods_written"),
                "bytes_written": stats.get("bytes_written"),
            })
        return out

    # ------------------------------------------------------------------
    # pod-granular diff + reachability
    # ------------------------------------------------------------------
    def pod_digests_of(self, tid: int, *, missing_ok: bool = False
                       ) -> Set[str]:
        try:
            m = self.store.get_manifest(tid)
        except (KeyError, FileNotFoundError):
            if not missing_ok:
                raise
            return set()
        return {meta["d"] for meta in m.get("pods", {}).values()}

    def diff(self, a: Ref, b: Ref) -> PodDelta:
        ta, tb = self.resolve(a), self.resolve(b)
        assert ta is not None and tb is not None
        da, db = self.pod_digests_of(ta), self.pod_digests_of(tb)
        only_a, only_b, shared = da - db, db - da, da & db

        def nbytes(digs: Iterable[str]) -> int:
            return sum(self.store.pod_nbytes(d) for d in digs)

        return PodDelta(tid_a=ta, tid_b=tb, only_a=only_a, only_b=only_b,
                        shared=shared, bytes_only_a=nbytes(only_a),
                        bytes_only_b=nbytes(only_b),
                        bytes_shared=nbytes(shared))

    def roots(self, extra: Iterable[Optional[int]] = ()) -> Set[int]:
        """GC roots: every branch tip, every tag, HEAD, plus extras."""
        with self._lock:
            out = set(self.branches.values()) | set(self.tags.values())
            head = self.head_commit()
            if head is not None:
                out.add(head)
            out.update(t for t in extra if t is not None)
            return out

    def live_commits(self, extra_roots: Iterable[Optional[int]] = (),
                     *, missing_ok: bool = False) -> Set[int]:
        """Commits reachable from any root by parent pointers.  The GC
        mark passes `missing_ok`: under multi-writer contention a walk
        can legitimately cross a manifest a previous sweep reclaimed
        (see `parent`)."""
        live: Set[int] = set()
        for root in self.roots(extra_roots):
            cur: Optional[int] = root
            while cur is not None and cur not in live:
                live.add(cur)
                cur = self.parent(cur, missing_ok=missing_ok)
        return live

    def reachable_digests(self, extra_roots: Iterable[Optional[int]] = (),
                          *, missing_ok: bool = False) -> Set[str]:
        """Pod digests referenced by any live commit (the GC mark set)."""
        out: Set[str] = set()
        for tid in self.live_commits(extra_roots, missing_ok=missing_ok):
            out |= self.pod_digests_of(tid, missing_ok=missing_ok)
        return out

    def forget(self, time_ids: Iterable[int]) -> None:
        """Drop swept commits from the parent cache (post-GC upkeep)."""
        with self._lock:
            for tid in time_ids:
                self._parents.pop(tid, None)
