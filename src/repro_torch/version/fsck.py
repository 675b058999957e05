"""Recovery fsck: classify torn saves, roll refs back, sweep debris.

The save commit protocol (core/checkpoint.py "Durability & recovery
contract") is strictly ordered:

    1. **pods**      — content-addressed blobs, each tmp + atomic rename
    2. **manifest**  — atomic rename; the commit point for the *data*
    3. **refs**      — compare-and-swap on the refs meta blob; the commit
                       point for *visibility* (HEAD / branch tips)

A crash can therefore leave, in decreasing order of likelihood:

  * orphan ``.tmp`` files and fully-written pods no manifest references
    (died in the 1→2 window) — harmless debris: content addressing means
    a re-run save rewrites or reuses them correctly;
  * a complete manifest no ref points at (died in the 2→3 window) — a
    dangling commit; refs still name the previous commit, which is the
    correct post-crash truth because the caller never saw the save
    succeed;
  * on *non-atomic* backends (modeled by `FaultyStore`'s torn mode) or
    under bitrot: truncated pod / manifest / refs blobs — the dangerous
    class, because a torn pod sits at a content address a *future* save
    would dedup against.

`fsck` classifies all of these and, with ``repair=True`` (default):

  * rolls every branch/tag/HEAD that names an incomplete commit back to
    its nearest **complete** ancestor (deleting refs with no complete
    ancestor), written via refs CAS so a concurrent repair can't clobber;
  * rebuilds refs entirely from manifests when the refs blob itself is
    torn (every childless complete tip becomes a branch — the
    `CommitDAG` bootstrap rule);
  * sweeps incomplete manifests (manifests-first crash ordering), empty
    and — in deep mode — corrupt pods, and ``.tmp``/stale-``.lock``
    debris;
  * **reaps dead writers**: every expired lease (core/lease.py) is
    removed along with its save intents, and a crashed sweeper's stuck
    ``gc_phase: "sweep"`` is reset — the store-level counterpart of
    breaking a dead process's CAS lockfile.  The reaped writer's
    in-flight pods become plain unreferenced orphans, swept by the same
    ``sweep_orphans`` path that handles torn 1→2-window debris.  A
    LIVE lease (an active peer) is honored end to end: its intent tids
    are not classified/swept even when their pods are still landing,
    and its intent digests are excluded from the orphan sweep.
  * repairs the file backend's legacy ``HEAD`` pointer.

Quick mode (default) checks existence and non-emptiness of every
referenced pod — O(store metadata), run on every `Chipmink` open.  For
a pod stored in **delta form** the quick scan also walks its chain: a
missing or empty link makes the pod unreadable, so it classifies as
missing/empty even though its own blob looks fine.  Deep mode
(``deep=True``) additionally reads every pod in the store and verifies
it deserializes — for a delta pod that means the full chain walk and
patch replay, the only way to catch a torn delta whose truncated bytes
are non-empty; run it after an unclean shutdown on a backend without
atomic renames, or whenever paranoia is cheap.

Delta-specific repairs: a **torn re-materialization** (corrupt whole
blob shadowing a still-valid delta form — the legal crash window of
`store.rematerialize_pod`) is healed by dropping the whole form
(``whole_forms_dropped``), after which the chain serves the bytes and
any commit the corruption had condemned is re-classified complete.  A
chain that is genuinely broken (base missing, torn link with no other
form) makes its referencing commits incomplete → the standard refs
rollback to the newest complete ancestor applies, and the dead chain
is swept like any other bad pod.  The orphan sweep follows chains too:
a base only reachable as some referenced delta pod's ancestor is
load-bearing, not debris.

fsck's exclusivity contract is now lease-shaped: refs repair was always
CAS-protected, and with live-lease awareness plus the stale-only lock
sweep the default scan is safe to run on open while peers hold writer
leases.  ``sweep_orphans=True`` remains exclusive-access-only (a
leaseless legacy writer mid-save still looks identical to debris).
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Any, Dict, List, Optional, Set, Tuple

import msgpack

from ..core.lease import LEASES_META_KEY, LeaseManager
from ..core.store import BaseStore
from .commit_graph import DEFAULT_BRANCH, REFS_META_KEY
from .refcount import REFCOUNTS_META_KEY

#: attempts to land the repaired refs blob via CAS before giving up.
MAX_REPAIR_RETRIES = 4


@dataclasses.dataclass
class FsckReport:
    deep: bool = False
    repaired: bool = False
    n_manifests: int = 0
    n_commits_complete: int = 0
    #: tid -> reason ("torn manifest", "missing pod <d>", "empty pod <d>",
    #: "corrupt pod <d>")
    incomplete: Dict[int, str] = dataclasses.field(default_factory=dict)
    #: tid -> digests referenced but absent (the un-masked counterpart of
    #: the old pod_nbytes()==0 behavior)
    missing_pods: Dict[int, List[str]] = dataclasses.field(
        default_factory=dict)
    #: zero-byte pods found in the store (a write no backend should have
    #: admitted — serialized pods are never empty)
    empty_pods: List[str] = dataclasses.field(default_factory=list)
    #: pods whose bytes fail to deserialize (deep mode only)
    corrupt_pods: List[str] = dataclasses.field(default_factory=list)
    #: ref -> (old tid, new tid or None); keys look like "branch:main",
    #: "tag:v1", "HEAD"
    refs_rolled_back: Dict[str, Tuple[Optional[int], Optional[int]]] = \
        dataclasses.field(default_factory=dict)
    refs_deleted: List[str] = dataclasses.field(default_factory=list)
    refs_rebuilt: bool = False
    legacy_head_repaired: bool = False
    #: torn re-materializations healed: corrupt whole blobs dropped in
    #: favor of the pod's still-valid delta chain
    whole_forms_dropped: List[str] = dataclasses.field(default_factory=list)
    n_tmp_removed: int = 0
    n_manifests_swept: int = 0
    n_pods_swept: int = 0
    #: expired leases reaped (dead writers/sweepers), live leases seen,
    #: and whether a crashed sweeper's stuck "sweep" phase was reset.
    leases_reaped: List[str] = dataclasses.field(default_factory=list)
    n_leases_live: int = 0
    gc_phase_reset: bool = False
    swept_pod_digests: List[str] = dataclasses.field(default_factory=list)
    #: the persisted refcount index (version/refcount.py) disagreed with
    #: the post-repair store and was rebuilt — drift is damage: a crash
    #: between a save's manifest put and its record_commit, or mid-evict
    #: between the index CAS and the deletes.
    refcounts_rebuilt: bool = False
    t_scan: float = 0.0
    t_repair: float = 0.0

    @property
    def clean(self) -> bool:
        """True iff the store needed no classification and no repair.
        A live lease is not damage (an active peer); a reaped one is
        (a writer died holding it)."""
        return not (self.incomplete or self.empty_pods or self.corrupt_pods
                    or self.refs_rolled_back or self.refs_deleted
                    or self.refs_rebuilt or self.legacy_head_repaired
                    or self.whole_forms_dropped
                    or self.n_tmp_removed or self.n_manifests_swept
                    or self.n_pods_swept or self.leases_reaped
                    or self.gc_phase_reset or self.refcounts_rebuilt)

    def as_dict(self) -> Dict[str, Any]:
        d = {k: v for k, v in self.__dict__.items()
             if k != "swept_pod_digests"}
        d["clean"] = self.clean
        return d


def _pod_state(store: BaseStore, digest_hex: str, deep: bool,
               cache: Dict[str, str]) -> str:
    """'ok' | 'missing' | 'empty' | 'corrupt' for one content address."""
    got = cache.get(digest_hex)
    if got is not None:
        return got
    state = "ok"
    try:
        if not store.has_pod(digest_hex):
            state = "missing"
        elif store.pod_nbytes(digest_hex) == 0:
            state = "empty"
        elif deep:
            # chain-resolving read: for a delta pod this walks every
            # link and replays the patches — the full validation.
            obj = msgpack.unpackb(store.get_pod(digest_hex), raw=False)
            if not isinstance(obj, dict) or "e" not in obj:
                state = "corrupt"
        else:
            # quick mode: a delta pod is only readable if its whole
            # chain exists with non-empty links; pod_chain parses the
            # delta headers (no payload reads) and raises on a break.
            for link in store.pod_chain(digest_hex):
                if store.pod_nbytes(link) == 0:
                    state = "empty"
                    break
    except FileNotFoundError:
        state = "missing"
    except Exception:
        # failed decompression, codec tag garbage, msgpack truncation,
        # a cyclic chain — all the faces a torn pod wears.
        state = "corrupt"
    cache[digest_hex] = state
    return state


def fsck(store: BaseStore, *, repair: bool = True, deep: bool = False,
         sweep_orphans: bool = False, reap_leases: bool = True,
         leases: Optional[LeaseManager] = None) -> FsckReport:
    """Scan `store` for torn-save damage; repair and sweep if asked.

    Returns an `FsckReport`.  With ``sweep_orphans=True`` pods referenced
    by *no* manifest at all are also deleted (off by default: a pod
    parked by a crashed 1→2-window save is harmless, and a leaseless
    writer mid-save would look identical — only enable when the caller
    owns the store exclusively, e.g. the crash-matrix harness).  Pods
    and tids pinned by a LIVE lease's save intent are never classified
    as damage or swept, so the default scan coexists with active peers.

    ``reap_leases`` (with ``repair``) removes expired leases and their
    orphaned intents — dead writers' liveness debris; pass a configured
    `LeaseManager` via ``leases`` to share its clock/owner (tests drive
    expiry with a fake clock), else one is built on the store's default
    wall clock.
    """
    rep = FsckReport(deep=deep, repaired=repair)
    t0 = _time.perf_counter()

    # ---- 0. lease debris: reap dead writers, honor live ones ----------
    live_tids: Set[int] = set()
    live_digests: Set[str] = set()
    if store.get_meta(LEASES_META_KEY) is not None:
        mgr = leases if leases is not None else LeaseManager(store)
        if repair and reap_leases:
            resets0 = mgr.n_phase_resets
            rep.leases_reaped = mgr.reap_expired()
            rep.gc_phase_reset = mgr.n_phase_resets > resets0
        t, d = mgr.live_intents()
        live_tids, live_digests = set(t), set(d)
        rep.n_leases_live = len(mgr.live_leases())

    # ---- 1. classify every manifest -----------------------------------
    pod_cache: Dict[str, str] = {}
    complete: Dict[int, Set[str]] = {}      # tid -> referenced digests
    parents: Dict[int, Optional[int]] = {}
    for tid in store.list_time_ids():
        rep.n_manifests += 1
        try:
            m = store.get_manifest(tid)
            digs = {meta["d"] for meta in m.get("pods", {}).values()}
        except Exception:
            if tid in live_tids:
                continue      # a live peer's save is mid-landing, not torn
            rep.incomplete[tid] = "torn manifest"
            continue
        parents[tid] = m.get("parent")
        bad: Optional[str] = None
        for d in sorted(digs):
            state = _pod_state(store, d, deep, pod_cache)
            if state == "missing":
                rep.missing_pods.setdefault(tid, []).append(d)
            if state != "ok" and bad is None:
                bad = f"{state} pod {d}"
        if bad is not None:
            if tid in live_tids:
                rep.missing_pods.pop(tid, None)   # in-flight, not damage
            else:
                rep.incomplete[tid] = bad
        else:
            complete[tid] = digs
    rep.n_commits_complete = len(complete)

    # deep/sweep integrity of unreferenced pods: a torn orphan pod sits
    # at a content address future saves will dedup against, so it must
    # be found even though no manifest names it.
    if deep or sweep_orphans:
        for d in store.list_pods():
            _pod_state(store, d, deep, pod_cache)
    rep.empty_pods = sorted(d for d, s in pod_cache.items()
                            if s == "empty")
    rep.corrupt_pods = sorted(d for d, s in pod_cache.items()
                              if s == "corrupt")

    # ---- 2. plan the refs repair ---------------------------------------
    complete_tids = set(complete)

    def newest_complete_ancestor(tid: Optional[int]) -> Optional[int]:
        seen: Set[int] = set()
        cur = tid
        while cur is not None and cur not in seen:
            seen.add(cur)
            if cur in complete_tids:
                return cur
            if cur not in parents:
                # torn manifest: the parent pointer is unreadable, so the
                # chain breaks here.  TimeIDs are globally monotone and a
                # parent always lands before its child, so the newest
                # complete commit older than the break is the best
                # recoverable ancestor.
                older = [t for t in complete_tids if t < cur]
                return max(older) if older else None
            cur = parents[cur]
        return None

    rep.t_scan = _time.perf_counter() - t0
    if not repair:
        return rep

    # ---- 2b. heal torn re-materializations ------------------------------
    # A corrupt pod that ALSO has a delta form is rematerialize_pod's
    # crash window: the half-written whole blob shadows a chain that can
    # still serve the bytes.  Drop the whole form, re-verify the pod via
    # the chain, and re-classify any commit the corruption condemned.
    t0 = _time.perf_counter()
    for d in list(rep.corrupt_pods):
        if not store.drop_whole_form(d):
            continue
        try:
            obj = msgpack.unpackb(store.get_pod(d), raw=False)
            ok = isinstance(obj, dict) and "e" in obj
        except Exception:
            ok = False
        if ok:
            pod_cache[d] = "ok"
            rep.corrupt_pods.remove(d)
            rep.whole_forms_dropped.append(d)
        # not ok: the delta form is torn too — the pod stays corrupt and
        # both forms go in the sweep below.
    if rep.whole_forms_dropped:
        for tid in sorted(rep.incomplete):
            try:
                m = store.get_manifest(tid)
                digs = {meta["d"] for meta in m.get("pods", {}).values()}
            except Exception:
                continue                      # torn manifest: still dead
            if all(pod_cache.get(d) == "ok"
                   or _pod_state(store, d, deep, pod_cache) == "ok"
                   for d in digs):
                del rep.incomplete[tid]
                rep.missing_pods.pop(tid, None)
                complete[tid] = digs
                parents[tid] = m.get("parent")
        complete_tids = set(complete)
        rep.n_commits_complete = len(complete)

    # ---- 3. repair refs via CAS ----------------------------------------
    for _ in range(MAX_REPAIR_RETRIES):
        refs_blob = store.get_meta(REFS_META_KEY)
        branches: Dict[str, int] = {}
        tags: Dict[str, int] = {}
        head_branch: Optional[str] = DEFAULT_BRANCH
        detached: Optional[int] = None
        refs_ok = False
        if refs_blob is not None:
            try:
                refs = msgpack.unpackb(refs_blob, raw=False)
                branches = {str(k): int(v)
                            for k, v in refs["branches"].items()}
                tags = {str(k): int(v) for k, v in refs["tags"].items()}
                head_branch = refs["head_branch"]
                detached = refs["detached"]
                refs_ok = True
            except Exception:
                refs_ok = False
        # a current branch with no commits yet has no branches entry (an
        # "unborn" branch — e.g. the default branch of a store whose only
        # commits live on session branches); that is healthy state, not a
        # deleted branch, and must survive the repair as-is.
        head_unborn = refs_ok and head_branch is not None \
            and head_branch not in branches
        if not refs_ok:
            # refs blob absent (pre-versioning store) or torn: rebuild
            # from the complete manifests, bootstrap-style — every
            # childless complete tip becomes a branch.
            rep.refs_rebuilt = refs_blob is not None and bool(
                rep.n_manifests)
            branches, tags = {}, {}
            head_branch, detached = DEFAULT_BRANCH, None
            with_children = {p for t, p in parents.items()
                             if p is not None and t in complete_tids}
            tips = [t for t in sorted(complete_tids)
                    if t not in with_children]
            if tips:
                newest = max(tips)
                branches[DEFAULT_BRANCH] = newest
                for t in tips:
                    if t != newest:
                        branches[f"tip-{t}"] = t
            if refs_blob is None and not branches:
                break                         # empty store: nothing to do
        else:
            rep.refs_rebuilt = False

        rep.refs_rolled_back = {}
        rep.refs_deleted = []
        for name, tid in sorted(branches.items()):
            if tid in complete_tids:
                continue
            new = newest_complete_ancestor(tid)
            if new is None:
                rep.refs_deleted.append(f"branch:{name}")
            else:
                rep.refs_rolled_back[f"branch:{name}"] = (tid, new)
        for name, tid in sorted(tags.items()):
            if tid in complete_tids:
                continue
            new = newest_complete_ancestor(tid)
            if new is None:
                rep.refs_deleted.append(f"tag:{name}")
            else:
                rep.refs_rolled_back[f"tag:{name}"] = (tid, new)
        for key, (_, new) in rep.refs_rolled_back.items():
            kind, name = key.split(":", 1)
            (branches if kind == "branch" else tags)[name] = new
        for key in rep.refs_deleted:
            kind, name = key.split(":", 1)
            (branches if kind == "branch" else tags).pop(name, None)

        if head_branch is not None and head_branch not in branches \
                and not head_unborn:
            # the current branch itself was deleted: fall back to the
            # default branch, else any surviving branch, else detach at
            # the newest complete commit.
            if DEFAULT_BRANCH in branches:
                head_branch = DEFAULT_BRANCH
            elif branches:
                head_branch = sorted(branches)[0]
            else:
                head_branch = None
                detached = max(complete_tids) if complete_tids else None
        if head_branch is None and detached is not None \
                and detached not in complete_tids:
            new = newest_complete_ancestor(detached)
            rep.refs_rolled_back["HEAD"] = (detached, new)
            detached = new

        new_blob = msgpack.packb({
            "branches": branches, "tags": tags,
            "head_branch": head_branch, "detached": detached,
        }, use_bin_type=True)
        if new_blob == refs_blob:
            break                             # nothing to change
        if store.compare_and_put_meta(REFS_META_KEY, refs_blob, new_blob):
            break
        # lost a CAS race (concurrent repair): re-read and re-plan.
    else:
        raise RuntimeError(
            "fsck: refs kept changing underneath the repair — is a "
            "writer active?  fsck requires exclusive store access.")

    # ---- 4. sweep debris ------------------------------------------------
    # manifests first: the same crash-safe ordering as GC — an interrupted
    # fsck must never leave a manifest naming a pod fsck deleted.
    for tid in sorted(rep.incomplete):
        if store.delete_manifest(tid):
            rep.n_manifests_swept += 1
    bad_pods = set(rep.empty_pods) | set(rep.corrupt_pods)
    if sweep_orphans:
        referenced = set().union(*complete.values()) if complete else set()
        # chain closure: a delta pod's bases are load-bearing even when
        # no complete manifest names them directly — a base reachable
        # only as an ancestor link must survive the orphan sweep.
        for d in list(referenced):
            try:
                referenced.update(store.pod_chain(d))
            except (FileNotFoundError, ValueError):
                pass
        bad_pods |= {d for d in store.list_pods() if d not in referenced}
    bad_pods -= live_digests      # pinned by a live peer's save intent
    for d in sorted(bad_pods):
        if store.has_pod(d):
            store.delete_pod(d)
            rep.n_pods_swept += 1
            rep.swept_pod_digests.append(d)
    rep.n_tmp_removed = store.sweep_tmp()
    rep.legacy_head_repaired = store.repair_head()

    # ---- 5. true up the refcount index ----------------------------------
    # Only for stores that opted in (the blob exists): the index is pure
    # derived state, so after any repair the store itself is the truth —
    # rebuild and flag drift (a crash between a save's manifest put and
    # its record_commit, or mid-evict between the index CAS and the
    # deletes, leaves exactly this signature).
    if store.get_meta(REFCOUNTS_META_KEY) is not None:
        from .refcount import RefcountIndex    # circular-free: runtime
        rep.refcounts_rebuilt = RefcountIndex(store).rebuild()
    rep.t_repair = _time.perf_counter() - t0
    return rep
