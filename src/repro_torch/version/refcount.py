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
  * A commit codes what it changes, not the store.  Every index on one
    store object in this process shares a memo of the blob this process
    last read or wrote there and the state it decodes to.  A mutation
    that reads that blob back (the same object, else the same bytes)
    decodes nothing; it packs the `counts` entries it touched and joins
    them with slices of the memo's blob, and packs `tids`, `children`
    and `chains` whole.  The bytes are those `_encode` gives, which stays
    the oracle.  Any other blob (a peer process's, a torn one, fsck's
    rebuild, a first contact) decodes as before and re-seeds the memo; a
    lost CAS or an error mid-mutation drops it, since the state was
    changed in place for a blob that never landed.  The memo's lock is
    held from the read of the blob to the end of its CAS, so two
    indexes on one store (a pool's podding threads) never change the
    shared state at once; across processes the CAS alone composes.

Concurrency: mutations are read-modify-CAS loops (the `LeaseManager`
pattern), so concurrent writers on one store compose.  The *reclaim*
additionally honors the gc lease + sweep fence when the caller runs
multi-writer (intent-pinned tids/digests are excluded exactly like the
mark-and-sweep path); single-process callers (the session service)
serialize reclaim against their own savers instead.
"""
from __future__ import annotations

import threading
import weakref
from collections import Counter
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import msgpack
import numpy as np

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


#: the outer map's keys, packed
_TIDS, _COUNTS, _CHILDREN, _CHAINS = (
    msgpack.packb(k) for k in ("tids", "counts", "children", "chains"))


def _map_header(n: int) -> bytes:
    """msgpack's header of an `n`-entry map: fixmap, map 16 or map 32."""
    if n < 16:
        return bytes((0x80 | n,))
    if n < 0x10000:
        return b"\xde" + n.to_bytes(2, "big")
    return b"\xdf" + n.to_bytes(4, "big")


def _head(state: Dict[str, Any], n_counts: int) -> bytes:
    """The encoded index up to its first `counts` entry."""
    return (b"\x84" + _TIDS + msgpack.packb(sorted(state["tids"]))
            + _COUNTS + _map_header(n_counts))


def _tail(state: Dict[str, Any]) -> bytes:
    """The encoded index after its last `counts` entry."""
    ch, chains = state["children"], state["chains"]
    return (_CHILDREN
            + msgpack.packb({str(t): ch[t] for t in sorted(ch)},
                            use_bin_type=True)
            + _CHAINS
            + msgpack.packb({d: chains[d] for d in sorted(chains)},
                            use_bin_type=True))


def _key_array(keys: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """`keys` as an array of ASCII bytes, in the order of the strs, and
    each key's length.  A key outside ASCII, or holding a NUL (numpy's
    padding), raises ValueError: the commit then encodes whole."""
    joined = "".join(keys).encode("ascii")
    if b"\x00" in joined:
        raise ValueError("a key holds NUL")
    kl = np.fromiter(map(len, keys), np.int64, len(keys))
    if len(keys) and kl.min() == kl.max() > 0:     # digests: one width
        return np.frombuffer(joined, f"S{kl[0]}"), kl
    return np.array(keys, "S"), kl


def _entry_nbytes(kl: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bytes of each packed `counts` entry, a str key of `kl` bytes and
    the int `v`, each in msgpack's smallest form."""
    return (kl + np.select([kl < 32, kl < 0x100, kl < 0x10000], [1, 2, 3], 5)
            + np.select([(v >= -32) & (v < 0x80), (v >= -0x80) & (v < 0x100),
                         (v >= -0x8000) & (v < 0x10000),
                         (v >= -2**31) & (v < 2**32)], [1, 2, 3, 5], 9))


def _n_entries(state: Dict[str, Any]) -> int:
    return sum(len(state[k]) for k in ("tids", "counts", "children",
                                       "chains"))


class _Memo:
    """The index blob this process last read or wrote on one store, the
    state it decodes to, and where its `counts` entries lie: `keys` in
    canonical order and `offs`, each entry's byte offset in `blob` and
    then the end of the last (None where `lay_out` could not size them).
    Shared by every `RefcountIndex` on the store; `lock` is held from a
    read of the blob to the end of its CAS."""

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.drop()

    def drop(self) -> None:
        self.blob: Optional[bytes] = None
        self.state: Optional[Dict[str, Any]] = None
        self.keys: Optional[np.ndarray] = None
        self.offs: Optional[np.ndarray] = None

    def holds(self, blob: Optional[bytes]) -> bool:
        """Whether `blob`, just read, is the one the memo describes (on
        `MemoryStore` the same object, which `==` answers unread)."""
        return self.blob is not None and blob == self.blob

    def seed(self, blob: bytes, state: Dict[str, Any],
             keys: Optional[np.ndarray] = None,
             offs: Optional[np.ndarray] = None) -> None:
        """Hold `blob` and `state`; where the layout is not given, find
        it."""
        self.blob, self.state, self.keys, self.offs = blob, state, keys, offs
        if keys is None:
            self.lay_out()

    def lay_out(self) -> None:
        """Find where each `counts` entry lies in `blob` from `state`
        (which `blob` encodes).  None where the sizes do not add up to
        the blob's, as for keys or values other than str and int: the
        next commit then encodes whole."""
        state = self.state
        counts = state["counts"]
        try:
            keys = sorted(counts)
            karr, kl = _key_array(keys)
            lens = _entry_nbytes(kl, np.fromiter(
                (counts[k] for k in keys), np.int64, len(keys)))
        except (TypeError, ValueError, OverflowError):
            return
        offs = np.empty(len(keys) + 1, np.int64)
        offs[0] = len(_head(state, len(keys)))
        np.cumsum(lens, out=offs[1:])
        offs[1:] += offs[0]
        if int(offs[-1]) + len(_tail(state)) == len(self.blob):
            self.keys, self.offs = karr, offs

    def splice(self, state: Dict[str, Any],
               touched: Dict[str, Optional[int]]
               ) -> Tuple[bytes, np.ndarray, np.ndarray, int]:
        """The encoding of `state`, the memo's state after a mutation
        that changed no `counts` entry outside `touched` (its keys in
        sorted order, each with its new count or None where it went):
        the untouched entries as slices of `blob`, the touched ones
        packed afresh, `tids`, `children` and `chains` packed whole.
        Returns it with its `keys`, `offs` and the entries packed."""
        K, O, n = self.keys, self.offs, len(self.keys)
        m = len(touched)
        T, tkl = _key_array(list(touched))
        if T.itemsize != K.itemsize:    # one width for both
            w = f"S{max(T.itemsize, K.itemsize)}"
            K, T = K.astype(w), T.astype(w)
        pos = np.searchsorted(K, T)
        hit = np.zeros(m, bool)
        inside = pos < n
        hit[inside] = K[pos[inside]] == T[inside]
        live = np.fromiter((v is not None for v in touched.values()),
                           bool, m)
        fresh = {t: v for t, v in touched.items() if v is not None}
        packed = msgpack.packb(fresh, use_bin_type=True)
        # each touched key's new bytes in `packed` (none where deleted)
        el = np.zeros(m, np.int64)
        el[live] = _entry_nbytes(tkl[live], np.fromiter(
            fresh.values(), np.int64, len(fresh)))
        at = np.empty(m + 1, np.int64)
        at[0] = len(_map_header(len(fresh)))
        np.cumsum(el, out=at[1:])
        at[1:] += at[0]
        n_new = n - int((hit & ~live).sum()) + int((~hit & live).sum())
        head, tail = _head(state, n_new), _tail(state)
        # the old bytes kept before each touched key and after the last,
        # between each touched key's new bytes
        pieces = [head] + [b""] * (2 * m + 1) + [tail]
        pieces[1::2] = map(memoryview(self.blob).__getitem__, map(
            slice, np.insert(O[pos + hit], 0, O[0]).tolist(),
            np.append(O[pos], O[n]).tolist()))
        pieces[2:-1:2] = map(packed.__getitem__, map(
            slice, at[:-1].tolist(), at[1:].tolist()))
        blob = b"".join(pieces)
        # the layout of the new blob
        lens = np.diff(O)
        lens[pos[hit & live]] = el[hit & live]
        keys, gone, ins = K, hit & ~live, ~hit & live
        where = pos[ins]
        if gone.any():
            keep = np.ones(n, bool)
            keep[pos[gone]] = False
            keys, lens = keys[keep], lens[keep]
            where = where - np.searchsorted(pos[gone], where)
        if ins.any():
            keys = np.insert(keys, where, T[ins])
            lens = np.insert(lens, where, el[ins])
        offs = np.empty(len(lens) + 1, np.int64)
        offs[0] = len(head)
        np.cumsum(lens, out=offs[1:])
        offs[1:] += offs[0]
        n_packed = (len(fresh) + len(state["tids"]) + len(state["children"])
                    + len(state["chains"]))
        return blob, keys, offs, n_packed


#: one memo per store object, for every index on it in this process
_MEMOS: "weakref.WeakKeyDictionary[BaseStore, _Memo]" = (
    weakref.WeakKeyDictionary())
_MEMOS_LOCK = threading.Lock()


def _memo_of(store: BaseStore) -> _Memo:
    with _MEMOS_LOCK:
        memo = _MEMOS.get(store)
        if memo is None:
            memo = _MEMOS[store] = _Memo()
        return memo


class RefcountIndex:
    """The persistent index over one store.  Cheap to construct; every
    method re-reads the blob, so instances on different `Chipmink`s (or
    processes) sharing a store stay coherent through the CAS.  The views
    (`counts`, ...) may be the state the store's memo shares with every
    index on the store in this process, which their commits change in
    place: `state_snapshot()` is a private copy."""

    def __init__(self, store: BaseStore, *,
                 max_cas_retries: int = MAX_CAS_RETRIES) -> None:
        self.store = store
        self.max_cas_retries = max_cas_retries
        self._memo = _memo_of(store)
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
        """Deep copy of the in-memory state, taken while no index on the
        store mutates it."""
        with self._memo.lock:
            s = self._state
            return {"tids": set(s["tids"]), "counts": dict(s["counts"]),
                    "children": dict(s["children"]),
                    "chains": dict(s["chains"])}

    # -- persistence -------------------------------------------------------
    def load(self) -> None:
        """Refresh the in-memory view from the store (no mutation)."""
        memo = self._memo
        with memo.lock:
            blob = self.store.get_meta(REFCOUNTS_META_KEY)
            if memo.holds(blob):
                self._state, self.missing = memo.state, False
                return
            memo.drop()
            state = self._decode(blob)
            self.missing = state is None
            if state is not None:
                self._state = state
                memo.seed(blob, state)

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
        memo = self._memo
        with memo.lock:
            for _ in range(self.max_cas_retries):
                blob = self.store.get_meta(REFCOUNTS_META_KEY)
                state = _scan_state(self.store)
                new = self._encode(state)
                if new == blob:
                    memo.seed(blob, state)
                    self._state, self.missing = state, False
                    return False
                if self.store.compare_and_put_meta(REFCOUNTS_META_KEY,
                                                   blob, new):
                    memo.seed(new, state)
                    self._state, self.missing = state, False
                    return True
                memo.drop()
        raise RefcountCASError(
            f"refcount rebuild lost {self.max_cas_retries} CAS races")

    def _mutate(self, fn) -> Tuple[int, int]:
        """Read-modify-CAS: `fn(state)` changes the state in place and
        returns the `counts` entries it changed, in key order, each with
        its new count or None where it went (`_Memo.splice`), or None
        where it changed nothing.  It must be pure in its input
        state (it reruns against the reloaded blob after a lost race).
        A missing or corrupt blob is rebuilt from the store first, so
        every mutation self-heals.  On the blob the store's memo holds,
        nothing is decoded and only the changed entries are packed.
        Returns (entries coded, twice the entries of the index): a whole
        decode and encode code all of them."""
        memo = self._memo
        with memo.lock:
            for _ in range(self.max_cas_retries):
                blob = self.store.get_meta(REFCOUNTS_META_KEY)
                try:
                    out = self._mutate_once(memo, blob, fn)
                except BaseException:
                    memo.drop()         # `fn` may have half-run on it
                    raise
                if out is not None:
                    return out
                memo.drop()             # lost the race: no blob is its
        raise RefcountCASError(
            f"refcount mutation lost {self.max_cas_retries} CAS races")

    def _mutate_once(self, memo: _Memo, blob: Optional[bytes],
                     fn) -> Optional[Tuple[int, int]]:
        """One read-modify-CAS of `_mutate` on `blob`; None when the CAS
        is lost."""
        coded = 0
        known = memo.holds(blob)
        if known:
            state = memo.state
        else:
            memo.drop()
            state = self._decode(blob)
            if state is None:
                state = _scan_state(self.store)
            coded += _n_entries(state)
        touched = fn(state)
        if known and touched is None:
            self._state, self.missing = state, False
            return coded, 2 * _n_entries(state)
        new = None
        if known and memo.keys is not None:
            try:
                new, keys, offs, packed = memo.splice(state, touched)
                coded += packed
            except (TypeError, ValueError, OverflowError):
                new = None      # a key or count the splice cannot size
        if new is None:
            new, keys, offs = self._encode(state), None, None
            coded += _n_entries(state)
        if new == blob:
            memo.seed(blob, state, keys, offs)
        elif self.store.compare_and_put_meta(REFCOUNTS_META_KEY, blob, new):
            memo.seed(new, state, keys, offs)
        else:
            return None
        self._state, self.missing = state, False
        return coded, 2 * _n_entries(state)

    # -- mutations ---------------------------------------------------------
    def record_commit(self, time_id: int,
                      manifest: Dict[str, Any]) -> Tuple[int, int]:
        """Count one freshly-put manifest.  Idempotent per TimeID (the
        commit step retries as a unit), so a retried put never
        double-counts.  Returns `_mutate`'s entries coded and whole."""
        pods = manifest.get("pods", {})
        digests = sorted({meta["d"] for meta in pods.values()})
        links = [(meta["d"], meta["delta_of"]) for meta in pods.values()
                 if "delta_of" in meta]
        parent = manifest.get("parent")

        def fn(state: Dict[str, Any]) -> Optional[Dict[str, int]]:
            if time_id in state["tids"]:
                return None
            state["tids"].add(time_id)
            counts = state["counts"]
            touched = {}
            for d in digests:
                touched[d] = counts[d] = counts.get(d, 0) + 1
            if parent is not None:
                ch = state["children"]
                ch[parent] = ch.get(parent, 0) + 1
            for d, base in links:
                state["chains"][d] = base
            return touched

        return self._mutate(fn)

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

        def fn(state: Dict[str, Any]) -> Dict[str, Optional[int]]:
            state["tids"].difference_update(dead_tids)
            counts = state["counts"]
            touched: Dict[str, Optional[int]] = {}
            for d in sorted(pod_decrements):
                c = counts.get(d, 0) - pod_decrements[d]
                if c > 0:
                    counts[d] = c
                elif d in dead_pod_set:
                    counts.pop(d, None)
                    c = None
                else:
                    counts[d] = c = 0      # pinned survivor
                touched[d] = c
            ch = state["children"]
            for t, n in child_decrements.items():
                c = ch.get(t, 0) - n
                if c > 0:
                    ch[t] = c
                else:
                    ch.pop(t, None)
            for d in drop_chains:
                state["chains"].pop(d, None)
            return touched

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
        # a private copy: the index's state may be the one every index on
        # the store in this process shares, and their commits change it
        snap = index.state_snapshot()

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
        children = snap["children"]
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
        counts = snap["counts"]
        n_counted = len(counts)
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
        chains = snap["chains"]
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
        stats.n_commits_live = len(snap["tids"]) - len(dead_tids)
        stats.n_pods_live = n_counted - len(dead_pods)

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
