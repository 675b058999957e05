"""Store leases: fencing tokens, save intents, and fenced GC phases.

Every save is a recoverable transaction, but that protocol alone
assumed a single writer: the GC validate→sweep window and freshly-written
but uncommitted pods are unprotected the moment a second process opens
the same store.  This module is the liveness layer that closes both,
built entirely on the one cross-process primitive every backend already
has — `compare_and_put_meta` (the refs CAS).

All lease state lives in ONE metadata blob (``LEASES_META_KEY``):

    {"fence":    int,          # monotone token counter (see Fencing)
     "gc_phase": "idle"|"sweep",
     "gc_holder": lease_id|None,
     "leases":  {lease_id: {"kind": "writer"|"gc", "owner": str,
                            "fence": int, "expires": float,
                            "tids": [int], "digests": [str]}}}

Every mutation is a read → modify → CAS loop (`_mutate`): a lost race
reloads the winner's blob and re-applies, exactly the refs-level rebase
of `CommitDAG._commit_refs`.  Linearizing all lease traffic through one
blob is the point, not a limitation — it is what makes the sweep fence
below airtight.

Leases
------
* **writer** leases are shared: any number may coexist.  A writer holds
  one for the lifetime of its `Chipmink` and renews it (heartbeat, or
  inline at save time) before it expires.
* the **gc** lease is exclusive: `acquire_gc` refuses while a live gc
  lease exists (`LeaseHeld`) and *takes over* an expired one — the old
  holder is reaped and the fence counter bumps past its token.

Expiry uses wall-clock time (`time.time`): monotonic clocks are not
comparable across processes.  The usual lease caveat applies — clock
skew between hosts must be small relative to ``ttl_s`` (pick TTLs in
seconds, not milliseconds).  A dead process never blocks the store:
its lease expires, after which any peer (or fsck) reaps it.

Fencing
-------
``fence`` is a global monotone counter bumped by every acquisition.  A
lease is valid iff its record is still present, carries the same fence
token, and has not expired (`check`).  A writer that lost its lease
(expired + reaped, or taken over) fails `check` and must abort before
the refs CAS — it can no longer assume its intents pin anything.

Save intents (the uncommitted-pod problem)
------------------------------------------
A writer mid-save has written pods no manifest references yet; to a
concurrent GC they look exactly like dead debris.  Before writing (and
before *trusting dedup* — an aliased pod may be garbage about to be
swept), the writer registers its **intent** under its writer lease: the
TimeID it is about to commit plus every pod digest the manifest will
reference.  GC treats intent-pinned tids/digests as live.  After the
refs CAS lands, the commit is pinned by refs and the intent is cleared.

The sweep fence (closing the validate→sweep window)
---------------------------------------------------
Pinning alone leaves a race: an intent registered *after* GC snapshots
the live set but *before* it sweeps would not be seen.  The gc phase
closes it:

  * `begin_sweep` CASes ``gc_phase: idle → sweep`` and returns the
    pinned (tids, digests) snapshot **from the same blob the CAS
    replaced**.  Any concurrent intent registration mutates the same
    blob, so one of the two CASes loses and rebases: either the intent
    lands first (GC's retry re-reads it — pinned), or the phase flip
    lands first (the writer's retry observes ``sweep``).
  * `set_intent` observing ``gc_phase == "sweep"`` does NOT land; it
    waits (bounded by the gc lease TTL) until the sweeper finishes
    (`end_sweep`) or its lease expires — in which case the writer reaps
    the dead sweeper and proceeds.

Every intent is therefore either in the sweeper's snapshot or
registered strictly after the sweep — no third interleaving exists.
Writers never wait during mark/validate (the long phases); they block
only for the sweep itself, and only when saving concurrently with it.

Crash behavior at every step is exercised by the lease fault matrix
(`core.faults.LeaseFaultInjector` / tests): a writer killed mid-lease
leaves a record that expires and is reaped (its debris swept by fsck,
version/fsck.py); a sweeper killed mid-sweep leaves ``gc_phase:
"sweep"`` that clears the same way.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple

import msgpack

from .store import BaseStore

LEASES_META_KEY = "leases"

#: CAS attempts on the lease blob before declaring a livelock.  Lease
#: traffic is low-rate (acquire/renew/intent per save, not per pod), so
#: sustained conflict means a pathological store, not contention.
MAX_BLOB_CAS_RETRIES = 32


class LeaseLost(RuntimeError):
    """The caller's lease is gone: expired, reaped, or fenced out by a
    takeover.  A writer seeing this mid-save must abort before the refs
    CAS — its intents no longer pin anything."""


class LeaseHeld(RuntimeError):
    """An exclusive lease (gc) is live under another holder, or a gc
    sweep blocked intent registration past its deadline."""


@dataclasses.dataclass
class Lease:
    """A held lease.  ``fence`` is the validity token: compare it to the
    stored record, never to other leases (ordering across holders is the
    blob counter's business)."""

    lease_id: str
    kind: str                  # "writer" | "gc"
    owner: str
    fence: int
    expires: float
    ttl_s: float


def default_owner() -> str:
    """host:pid — enough to attribute a lease to a process for humans;
    uniqueness comes from the fence token, not the owner string."""
    return f"{socket.gethostname()}:{os.getpid()}"


def _fresh_blob() -> Dict[str, Any]:
    return {"fence": 0, "gc_phase": "idle", "gc_holder": None, "leases": {}}


class _SweepActive(Exception):
    """Internal: set_intent observed gc_phase == 'sweep' (live sweeper)."""


class LeaseManager:
    """Acquire/renew/release leases and intents over one store blob.

    ``clock`` is injectable (tests drive expiry deterministically with a
    fake clock); production uses wall-clock `time.time`.  ``op_hook`` is
    the lease fault-injection seam (`core.faults.LeaseFaultInjector`):
    called as ``op_hook(op, "before"|"after")`` around each *landed*
    blob CAS, so a crash-matrix test can kill the process on either side
    of every protocol step.
    """

    def __init__(self, store: BaseStore, *, owner: Optional[str] = None,
                 ttl_s: float = 10.0,
                 clock: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep,
                 op_hook: Optional[Callable[[str, str], None]] = None
                 ) -> None:
        self.store = store
        self.owner = owner if owner is not None else default_owner()
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self._sleep = sleep
        self._op_hook = op_hook
        # observability counters (read by benchmarks / fsck reports)
        self.n_blob_cas_races = 0
        self.n_takeovers = 0
        self.n_reaped = 0
        self.n_phase_resets = 0
        self.n_sweep_waits = 0

    def now(self) -> float:
        return self._clock()

    # ------------------------------------------------------------------
    # blob plumbing
    # ------------------------------------------------------------------
    def _load(self) -> Tuple[Optional[bytes], Dict[str, Any]]:
        raw = self.store.get_meta(LEASES_META_KEY)
        if raw is None:
            return None, _fresh_blob()
        try:
            blob = msgpack.unpackb(raw, raw=False)
            blob["leases"] = {str(k): v for k, v in blob["leases"].items()}
            return raw, blob
        except Exception:
            # torn blob (non-atomic backend / bitrot): leases are soft
            # state — rebuilding empty only costs liveness (writers
            # re-acquire; in-flight intents lose pinning and those saves
            # fail their pre-refs check), never correctness of committed
            # data.  The fence restarts; tokens are compared for
            # equality against the record, never ordered across blobs.
            return raw, _fresh_blob()

    def _hook(self, op: Optional[str], when: str) -> None:
        if op is not None and self._op_hook is not None:
            self._op_hook(op, when)

    def _mutate(self, fn: Callable[[Dict[str, Any]], Any],
                op: Optional[str] = None) -> Any:
        """read → `fn(blob)` → CAS, rebasing on conflict.  `fn` mutates
        the blob in place and returns the caller's result; raising from
        `fn` aborts with nothing written (validation re-runs on the
        reloaded blob each retry, same contract as `_commit_refs`)."""
        delay = 0.0005
        for attempt in range(MAX_BLOB_CAS_RETRIES):
            raw, blob = self._load()
            out = fn(blob)
            new = msgpack.packb(blob, use_bin_type=True)
            if new == raw:
                return out                    # no-op mutation
            self._hook(op, "before")
            if self.store.compare_and_put_meta(LEASES_META_KEY, raw, new):
                self._hook(op, "after")
                return out
            self.n_blob_cas_races += 1
            if attempt >= 2:                  # first retries are free
                self._sleep(delay)
                delay = min(delay * 2, 0.05)
        raise RuntimeError(
            f"lease blob CAS lost {MAX_BLOB_CAS_RETRIES} races in a row "
            "— livelocked store?")

    # ------------------------------------------------------------------
    # expiry / reaping
    # ------------------------------------------------------------------
    def _reap_in(self, blob: Dict[str, Any], now: float) -> List[str]:
        """Drop expired leases from `blob` (in place); reset a dead
        sweeper's phase.  Returns the reaped lease ids."""
        dead = [lid for lid, rec in blob["leases"].items()
                if rec["expires"] <= now]
        for lid in dead:
            del blob["leases"][lid]
            if blob.get("gc_holder") == lid:
                blob["gc_phase"] = "idle"
                blob["gc_holder"] = None
                self.n_phase_resets += 1
        return dead

    def reap_expired(self) -> List[str]:
        """Remove every expired lease (and its intents); a dead sweeper's
        ``gc_phase`` is reset to idle.  Called by fsck and implicitly by
        acquire/takeover paths.  Returns reaped lease ids."""
        if self.store.get_meta(LEASES_META_KEY) is None:
            return []                         # never materialize the blob

        def fn(blob: Dict[str, Any]) -> List[str]:
            return self._reap_in(blob, self.now())

        reaped = self._mutate(fn, op="reap")
        self.n_reaped += len(reaped)
        return reaped

    # ------------------------------------------------------------------
    # acquire / renew / release / check
    # ------------------------------------------------------------------
    def acquire_writer(self) -> Lease:
        """Shared writer lease: always succeeds (expired peers are
        reaped on the way, live peers coexist)."""
        return self._acquire("writer")

    def acquire_gc(self) -> Lease:
        """Exclusive gc lease: raises `LeaseHeld` while a live gc lease
        exists; an expired one is reaped and taken over (fence bumps
        past the dead holder's token)."""
        return self._acquire("gc")

    def _acquire(self, kind: str) -> Lease:
        def fn(blob: Dict[str, Any]) -> Lease:
            now = self.now()
            reaped = self._reap_in(blob, now)
            if kind == "gc":
                for lid, rec in blob["leases"].items():
                    if rec["kind"] == "gc":
                        raise LeaseHeld(
                            f"gc lease {lid} held by {rec['owner']} "
                            f"for another {rec['expires'] - now:.1f}s")
                self._last_takeover = bool(reaped)
            blob["fence"] += 1
            fence = blob["fence"]
            lease_id = f"{kind}-{fence}"
            blob["leases"][lease_id] = {
                "kind": kind, "owner": self.owner, "fence": fence,
                "expires": now + self.ttl_s, "tids": [], "digests": [],
            }
            return Lease(lease_id=lease_id, kind=kind, owner=self.owner,
                         fence=fence, expires=now + self.ttl_s,
                         ttl_s=self.ttl_s)

        lease = self._mutate(fn, op="acquire")
        if kind == "gc" and getattr(self, "_last_takeover", False):
            self.n_takeovers += 1
        return lease

    def _rec_of(self, blob: Dict[str, Any], lease: Lease) -> Dict[str, Any]:
        rec = blob["leases"].get(lease.lease_id)
        if rec is None or rec["fence"] != lease.fence:
            raise LeaseLost(
                f"lease {lease.lease_id} is gone (reaped or fenced out)")
        if rec["expires"] <= self.now():
            # present but expired: a peer may reap it any moment, so its
            # intents must not be trusted — same as already lost.
            raise LeaseLost(f"lease {lease.lease_id} expired")
        return rec

    def renew(self, lease: Lease) -> Lease:
        """Extend the lease by ``ttl_s`` from now.  Raises `LeaseLost`
        if it was reaped, fenced out, or already expired."""
        def fn(blob: Dict[str, Any]) -> float:
            rec = self._rec_of(blob, lease)
            rec["expires"] = self.now() + self.ttl_s
            return rec["expires"]

        lease.expires = self._mutate(fn, op="renew")
        return lease

    def release(self, lease: Lease) -> None:
        """Drop the lease (and its intents); a sweeper's phase resets.
        Releasing an already-lost lease is a no-op (idempotent — the
        caller is exiting either way)."""
        def fn(blob: Dict[str, Any]) -> None:
            rec = blob["leases"].get(lease.lease_id)
            if rec is None or rec["fence"] != lease.fence:
                return
            del blob["leases"][lease.lease_id]
            if blob.get("gc_holder") == lease.lease_id:
                blob["gc_phase"] = "idle"
                blob["gc_holder"] = None

        self._mutate(fn, op="release")

    def check(self, lease: Lease) -> None:
        """Raise `LeaseLost` unless the lease is present, unfenced, and
        unexpired.  Read-only: the writer's pre-refs-CAS gate."""
        _, blob = self._load()
        self._rec_of(blob, lease)

    # ------------------------------------------------------------------
    # intents
    # ------------------------------------------------------------------
    def set_intent(self, lease: Lease, *, time_ids: Iterable[int] = (),
                   digests: Iterable[str] = (),
                   wait_s: Optional[float] = None,
                   _op: str = "set_intent") -> None:
        """Declare the commit this writer is about to make: the TimeID
        and every pod digest its manifest will reference.  Replaces the
        lease's previous intent (one in-flight save per writer — the
        FIFO saver guarantees it).

        Blocks while a live sweeper is in its sweep phase (see module
        docstring) up to ``wait_s`` (default ``4 * ttl_s`` — enough for
        a dead sweeper to expire and be reaped), then raises `LeaseHeld`.
        """
        tids = sorted(int(t) for t in time_ids)
        digs = sorted(str(d) for d in digests)

        def fn(blob: Dict[str, Any]) -> None:
            rec = self._rec_of(blob, lease)
            if blob.get("gc_phase") == "sweep":
                holder = blob["leases"].get(blob.get("gc_holder") or "")
                if holder is not None and holder["expires"] > self.now():
                    raise _SweepActive()
                # dead sweeper: reap it and proceed (phase resets)
                self._reap_in(blob, self.now())
                if blob.get("gc_phase") == "sweep":
                    blob["gc_phase"] = "idle"
                    blob["gc_holder"] = None
                    self.n_phase_resets += 1
            rec["tids"] = tids
            rec["digests"] = digs
            # registering an intent is a liveness signal: refresh expiry
            # so a long save never outlives its own lease mid-write.
            rec["expires"] = self.now() + self.ttl_s
            lease.expires = rec["expires"]

        deadline = self.now() + (4 * self.ttl_s if wait_s is None
                                 else wait_s)
        while True:
            try:
                return self._mutate(fn, op=_op)
            except _SweepActive:
                if self.now() >= deadline:
                    raise LeaseHeld(
                        "gc sweep blocked intent registration past its "
                        "deadline (sweeper alive but stuck?)")
                self.n_sweep_waits += 1
                self._sleep(0.002)

    def clear_intent(self, lease: Lease) -> None:
        """Drop the intent after the refs CAS landed (the commit is now
        pinned by refs, not by the lease)."""
        self.set_intent(lease, time_ids=(), digests=(), _op="clear_intent")

    def live_intents(self) -> Tuple[Set[int], Set[str]]:
        """Union of (tids, digests) pinned by every live lease.  The
        read-only flavor (dry-run GC, fsck); sweepers use `begin_sweep`
        which snapshots atomically with the phase flip."""
        _, blob = self._load()
        now = self.now()
        tids: Set[int] = set()
        digs: Set[str] = set()
        for rec in blob["leases"].values():
            if rec["expires"] > now:
                tids.update(int(t) for t in rec["tids"])
                digs.update(str(d) for d in rec["digests"])
        return tids, digs

    def live_leases(self) -> List[str]:
        _, blob = self._load()
        now = self.now()
        return sorted(lid for lid, rec in blob["leases"].items()
                      if rec["expires"] > now)

    # ------------------------------------------------------------------
    # the sweep fence
    # ------------------------------------------------------------------
    def begin_sweep(self, lease: Lease) -> Tuple[Set[int], Set[str]]:
        """Flip ``gc_phase`` to "sweep" and return the pinned (tids,
        digests) snapshot — atomically, from the very blob the phase CAS
        replaced.  Requires a valid gc lease (`LeaseLost` otherwise)."""
        def fn(blob: Dict[str, Any]) -> Tuple[Set[int], Set[str]]:
            rec = self._rec_of(blob, lease)
            if rec["kind"] != "gc":
                raise ValueError("begin_sweep requires a gc lease")
            now = self.now()
            self._reap_in(blob, now)
            blob["gc_phase"] = "sweep"
            blob["gc_holder"] = lease.lease_id
            # sweeping is a liveness signal too
            rec["expires"] = now + self.ttl_s
            lease.expires = rec["expires"]
            tids: Set[int] = set()
            digs: Set[str] = set()
            for other in blob["leases"].values():
                if other["expires"] > now:
                    tids.update(int(t) for t in other["tids"])
                    digs.update(str(d) for d in other["digests"])
            return tids, digs

        return self._mutate(fn, op="begin_sweep")

    def end_sweep(self, lease: Lease) -> None:
        """Flip the phase back to idle (only if we still hold it)."""
        def fn(blob: Dict[str, Any]) -> None:
            if blob.get("gc_holder") == lease.lease_id:
                blob["gc_phase"] = "idle"
                blob["gc_holder"] = None

        self._mutate(fn, op="end_sweep")

    def gc_sweeping(self) -> bool:
        _, blob = self._load()
        if blob.get("gc_phase") != "sweep":
            return False
        holder = blob["leases"].get(blob.get("gc_holder") or "")
        return holder is not None and holder["expires"] > self.now()


class LeaseHeartbeat:
    """Daemon thread renewing one lease every ``interval_s`` (default
    ttl/3).  Transient store errors are absorbed with backoff
    (`RetryPolicy` semantics); a genuinely lost lease stops the beat and
    raises the flag — the owner observes ``lost`` at its next fencing
    check and aborts.  `stop()` is idempotent and joins the thread."""

    def __init__(self, manager: LeaseManager, lease: Lease,
                 interval_s: Optional[float] = None) -> None:
        import threading
        self.manager = manager
        self.lease = lease
        self.interval_s = (interval_s if interval_s is not None
                           else max(lease.ttl_s / 3.0, 0.01))
        self.lost = False
        self.n_renewals = 0
        self.n_transient_errors = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="chipmink-lease-heartbeat", daemon=True)

    def start(self) -> "LeaseHeartbeat":
        self._thread.start()
        return self

    def _run(self) -> None:
        from .faults import RetryPolicy, call_with_retries
        policy = RetryPolicy(max_retries=3, backoff_s=0.005)
        while not self._stop.wait(self.interval_s):
            try:
                _, nr = call_with_retries(
                    lambda: self.manager.renew(self.lease), policy)
                self.n_renewals += 1
                self.n_transient_errors += nr
            except LeaseLost:
                self.lost = True
                return
            except OSError:
                # retries exhausted: keep beating — the lease may still
                # be renewable before expiry on the next tick.
                self.n_transient_errors += 1

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
