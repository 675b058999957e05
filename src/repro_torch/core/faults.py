"""Fault injection + retry policy for the save/commit protocol.

Crash consistency is only real if it is *tested*: `FaultyStore` wraps any
`BaseStore` and injects named failures at every step of the commit
protocol (pods → manifest → refs), so the crash matrix in
tests/test_faults.py can kill a save transaction at each point, reopen
the store, run fsck (version/fsck.py), and assert refs always resolve to
a complete commit bit-identical to the pre-crash oracle.

Four failure modes, modeled on what real storage does:

  * ``crash``     — raise `InjectedCrash` at the point, either *before*
                    the backend effect (nothing landed) or *after* it
                    (the object landed, the caller died before the next
                    protocol step).
  * ``torn``      — write a truncated blob at the final location, then
                    crash.  Models a non-atomic backend (no tmp+rename,
                    e.g. raw object stores without atomic PUT) or bitrot;
                    the atomic-rename file backend can't produce this on
                    its own, which is exactly why fsck must still detect
                    it (deep mode).
  * ``transient`` — raise an `IOError` for the first N calls, then
                    succeed.  The save write path absorbs these through
                    `RetryPolicy` / `call_with_retries` (reported as
                    ``n_retries`` in save stats).
  * ``latency``   — sleep before delegating (slow-disk simulation for
                    benchmarks; never raises).

`InjectedCrash` subclasses `BaseException`, not `Exception`: retry loops
and blanket error handling must treat it as process death, never absorb
it — only the test harness catches it, then "reboots" by reopening the
store.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .lease import LEASES_META_KEY as _LEASES_KEY
from .store import BaseStore


class InjectedCrash(BaseException):
    """Simulated process death at a protocol step.  Deliberately NOT an
    Exception subclass so `except Exception` (and the transient-error
    retry policy) can never swallow a crash."""


#: write-path injection points, named after the store method they gate.
#: ``cas_meta`` is `compare_and_put_meta` — the refs commit step.
#: ``cas_lease`` is the same call aimed at the lease blob
#: (core/lease.py): splitting the point keeps the save crash matrix
#: (which arms ``cas_meta`` and expects the refs CAS) deterministic
#: while letting the lease matrix kill lease traffic specifically —
#: renewal-loss is ``transient`` here, an expiry race is ``latency``
#: here plus a short TTL.
#: ``put_pod_delta`` is the delta-form publish of a chain-stored pod;
#: ``rematerialize`` is `rematerialize_pod` — GC's mid-chain-sweep
#: rescue write (torn flavor: the whole form lands truncated while the
#: delta form survives, rematerialize_pod's own crash window).
#: ``delete_pod`` / ``delete_manifest`` are the sweep side (gc, fsck,
#: refcount eviction) — crash flavors model dying mid-reclaim (torn has
#: no meaning for a delete: it either unlinked or it didn't).
WRITE_POINTS = ("put_pod", "put_manifest", "put_meta", "cas_meta",
                "cas_lease", "put_pod_delta", "rematerialize",
                "delete_pod", "delete_manifest")
#: read-path points (transient/latency only; reads have no torn mode —
#: they never mutate the store).  ``get_lease`` is `get_meta` on the
#: lease blob, split from ``get_meta`` for the same reason as above.
READ_POINTS = ("get_pod", "get_manifest", "get_meta", "get_lease")


@dataclasses.dataclass
class Fault:
    """One armed failure.  `skip` calls at the point pass through before
    the fault fires; crash/torn fire once, transient fires `times` times,
    latency fires on every call."""

    point: str
    mode: str = "crash"            # crash | torn | transient | latency
    when: str = "before"           # crash only: before | after the effect
    skip: int = 0
    times: int = 1                 # transient only
    exc: Callable[[str], BaseException] = \
        lambda msg: IOError(msg)   # transient only
    seconds: float = 0.0           # latency only
    torn_fraction: float = 0.5     # torn only: fraction of bytes kept
    n_fired: int = 0

    def __post_init__(self) -> None:
        if self.point not in WRITE_POINTS + READ_POINTS:
            raise ValueError(f"unknown injection point {self.point!r}")
        if self.mode not in ("crash", "torn", "transient", "latency"):
            raise ValueError(f"unknown fault mode {self.mode!r}")
        if self.mode == "torn" and self.point not in WRITE_POINTS:
            raise ValueError("torn faults only apply to write points")


def crash_matrix_points() -> List[Tuple[str, str]]:
    """Every (point, flavor) a save transaction can die at, in protocol
    order.  Flavors: ``crash-before`` (step never ran), ``torn`` (step
    half-ran: truncated bytes at the final location), ``crash-after``
    (step ran, process died before the next one)."""
    out: List[Tuple[str, str]] = []
    for point in ("put_pod", "put_manifest", "cas_meta"):
        out.append((point, "crash-before"))
        out.append((point, "torn"))
        out.append((point, "crash-after"))
    return out


def delta_matrix_points() -> List[Tuple[str, str]]:
    """Every (point, flavor) a DELTA-CHAIN save transaction can die at,
    in protocol order: the delta publish itself, any whole-pod sibling
    write, and the manifest/refs commit steps.  The ``rematerialize``
    point (GC's mid-chain-sweep rescue) is armed separately — it fires
    inside `gc()`, not inside a save."""
    out: List[Tuple[str, str]] = []
    for point in ("put_pod_delta", "put_pod", "put_manifest", "cas_meta"):
        out.append((point, "crash-before"))
        out.append((point, "torn"))
        out.append((point, "crash-after"))
    return out


class FaultyStore(BaseStore):
    """Store wrapper that injects `Fault`s at protocol steps.

    Delegates everything to `inner` (stats included — the wrapper adds no
    accounting of its own beyond per-point call counts), and exposes the
    same interface, so it can stand in anywhere a `BaseStore` does:
    under a `Chipmink`, a `CommitDAG`, GC, or fsck.
    """

    def __init__(self, inner: BaseStore) -> None:
        # no super().__init__(): stats/_lock belong to `inner`, and the
        # wrapper must never double-count.
        self.inner = inner
        self._faults: List[Fault] = []
        self._flock = threading.Lock()
        self.calls: Dict[str, int] = {}

    # -- arming ------------------------------------------------------------
    def inject(self, fault: Fault) -> Fault:
        with self._flock:
            self._faults.append(fault)
        return fault

    def crash_at(self, point: str, when: str = "before",
                 skip: int = 0) -> Fault:
        return self.inject(Fault(point=point, mode="crash", when=when,
                                 skip=skip))

    def torn_at(self, point: str, skip: int = 0,
                fraction: float = 0.5) -> Fault:
        return self.inject(Fault(point=point, mode="torn", skip=skip,
                                 torn_fraction=fraction))

    def transient(self, point: str, times: int = 1, skip: int = 0,
                  exc: Optional[Callable[[str], BaseException]] = None
                  ) -> Fault:
        f = Fault(point=point, mode="transient", times=times, skip=skip)
        if exc is not None:
            f.exc = exc
        return self.inject(f)

    def latency(self, point: str, seconds: float) -> Fault:
        return self.inject(Fault(point=point, mode="latency",
                                 seconds=seconds))

    def arm(self, point: str, flavor: str, skip: int = 0) -> Fault:
        """Arm one crash-matrix flavor (see `crash_matrix_points`)."""
        if flavor == "crash-before":
            return self.crash_at(point, when="before", skip=skip)
        if flavor == "crash-after":
            return self.crash_at(point, when="after", skip=skip)
        if flavor == "torn":
            return self.torn_at(point, skip=skip)
        raise ValueError(f"unknown crash-matrix flavor {flavor!r}")

    def clear(self) -> None:
        """Disarm every fault and reset call counts (post-"reboot")."""
        with self._flock:
            self._faults = []
            self.calls = {}

    # -- firing ------------------------------------------------------------
    def _fire(self, point: str) -> Optional[Fault]:
        """Account one call at `point`; returns the fault that should
        raise/tear (crash, torn, transient), after sleeping any latency."""
        sleep_s = 0.0
        hit: Optional[Fault] = None
        with self._flock:
            i = self.calls.get(point, 0)
            self.calls[point] = i + 1
            for f in self._faults:
                if f.point != point or i < f.skip:
                    continue
                if f.mode == "latency":
                    f.n_fired += 1
                    sleep_s += f.seconds
                    continue
                if hit is not None:
                    continue
                if f.mode == "transient":
                    if f.n_fired >= f.times:
                        continue
                elif f.n_fired >= 1:       # crash/torn are one-shot
                    continue
                f.n_fired += 1
                hit = f
        if sleep_s:
            time.sleep(sleep_s)
        return hit

    @staticmethod
    def _torn(data: bytes, fraction: float) -> bytes:
        return data[:max(1, int(len(data) * fraction))]

    # -- stats / passthrough ------------------------------------------------
    @property
    def stats(self):
        return self.inner.stats

    @stats.setter
    def stats(self, value):  # pragma: no cover - BaseStore API symmetry
        self.inner.stats = value

    @property
    def compress(self) -> bool:
        return self.inner.compress

    def __getattr__(self, name: str) -> Any:
        # anything not intercepted (head(), root, backend internals) is
        # the inner store's business.
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    # -- pods ---------------------------------------------------------------
    def has_pod(self, digest_hex: str) -> bool:
        return self.inner.has_pod(digest_hex)

    def put_pod(self, digest_hex: str, data: bytes) -> bool:
        f = self._fire("put_pod")
        if f is None:
            return self.inner.put_pod(digest_hex, data)
        if f.mode == "transient":
            raise f.exc(f"injected transient error: put_pod {digest_hex}")
        if f.mode == "torn":
            # truncated bytes land at the FINAL content address (as a
            # non-atomic backend would leave them), then the process dies.
            # Torn bytes bypass the codec framing on purpose: that is
            # what real truncation does to a compressed blob too.
            self.inner._put_raw(digest_hex, self._torn(data,
                                                       f.torn_fraction))
            raise InjectedCrash(f"torn put_pod {digest_hex}")
        if f.when == "after":
            self.inner.put_pod(digest_hex, data)
        raise InjectedCrash(f"crash at put_pod[{f.when}] {digest_hex}")

    def get_pod(self, digest_hex: str) -> bytes:
        f = self._fire("get_pod")
        if f is not None and f.mode == "transient":
            raise f.exc(f"injected transient error: get_pod {digest_hex}")
        return self.inner.get_pod(digest_hex)

    def list_pods(self) -> List[str]:
        return self.inner.list_pods()

    def pod_nbytes(self, digest_hex: str) -> int:
        return self.inner.pod_nbytes(digest_hex)

    def delete_pod(self, digest_hex: str) -> int:
        f = self._fire("delete_pod")
        if f is None:
            return self.inner.delete_pod(digest_hex)
        if f.mode == "transient":
            raise f.exc(f"injected transient error: delete_pod {digest_hex}")
        if f.when == "after":
            self.inner.delete_pod(digest_hex)
        raise InjectedCrash(f"crash at delete_pod[{f.when}] {digest_hex}")

    # -- delta-chain pods ----------------------------------------------------
    def put_pod_delta(self, digest_hex: str, delta_blob: bytes) -> bool:
        f = self._fire("put_pod_delta")
        if f is None:
            return self.inner.put_pod_delta(digest_hex, delta_blob)
        if f.mode == "transient":
            raise f.exc(
                f"injected transient error: put_pod_delta {digest_hex}")
        if f.mode == "torn":
            # truncated delta bytes land at the final address (non-atomic
            # backend), then the process dies: fsck must catch a delta
            # blob that parses nowhere.
            self.inner._put_delta_raw(digest_hex,
                                      self._torn(delta_blob,
                                                 f.torn_fraction))
            raise InjectedCrash(f"torn put_pod_delta {digest_hex}")
        if f.when == "after":
            self.inner.put_pod_delta(digest_hex, delta_blob)
        raise InjectedCrash(
            f"crash at put_pod_delta[{f.when}] {digest_hex}")

    def rematerialize_pod(self, digest_hex: str) -> int:
        f = self._fire("rematerialize")
        if f is None:
            return self.inner.rematerialize_pod(digest_hex)
        if f.mode == "transient":
            raise f.exc(
                f"injected transient error: rematerialize {digest_hex}")
        if f.mode == "torn":
            # the rescue's whole form lands truncated while the delta
            # form survives — rematerialize_pod's crash window on a
            # non-atomic backend.  fsck heals this by dropping the torn
            # whole form (the chain still serves the bytes).
            data = self.inner.get_pod(digest_hex)
            blob = self.inner._encode_blob(data)
            self.inner._put_raw(digest_hex,
                                self._torn(blob, f.torn_fraction))
            raise InjectedCrash(f"torn rematerialize {digest_hex}")
        if f.when == "after":
            self.inner.rematerialize_pod(digest_hex)
        raise InjectedCrash(
            f"crash at rematerialize[{f.when}] {digest_hex}")

    def pod_base(self, digest_hex: str):
        return self.inner.pod_base(digest_hex)

    def pod_chain(self, digest_hex: str) -> List[str]:
        return self.inner.pod_chain(digest_hex)

    def pod_chain_depth(self, digest_hex: str) -> int:
        return self.inner.pod_chain_depth(digest_hex)

    def pod_whole_nbytes(self, digest_hex: str) -> int:
        return self.inner.pod_whole_nbytes(digest_hex)

    def list_delta_pods(self) -> List[str]:
        return self.inner.list_delta_pods()

    def drop_whole_form(self, digest_hex: str) -> bool:
        return self.inner.drop_whole_form(digest_hex)

    # -- manifests ----------------------------------------------------------
    def put_manifest(self, time_id: int, manifest: Dict[str, Any]) -> None:
        f = self._fire("put_manifest")
        if f is None:
            return self.inner.put_manifest(time_id, manifest)
        if f.mode == "transient":
            raise f.exc(f"injected transient error: put_manifest {time_id}")
        if f.mode == "torn":
            import msgpack
            blob = msgpack.packb(manifest, use_bin_type=True)
            self.inner._put_manifest_raw(time_id,
                                         self._torn(blob, f.torn_fraction))
            raise InjectedCrash(f"torn put_manifest {time_id}")
        if f.when == "after":
            self.inner.put_manifest(time_id, manifest)
        raise InjectedCrash(f"crash at put_manifest[{f.when}] {time_id}")

    def get_manifest(self, time_id: int) -> Dict[str, Any]:
        f = self._fire("get_manifest")
        if f is not None and f.mode == "transient":
            raise f.exc(f"injected transient error: get_manifest {time_id}")
        return self.inner.get_manifest(time_id)

    def list_time_ids(self) -> List[int]:
        return self.inner.list_time_ids()

    def manifest_nbytes(self, time_id: int) -> int:
        return self.inner.manifest_nbytes(time_id)

    def delete_manifest(self, time_id: int) -> int:
        f = self._fire("delete_manifest")
        if f is None:
            return self.inner.delete_manifest(time_id)
        if f.mode == "transient":
            raise f.exc(
                f"injected transient error: delete_manifest {time_id}")
        if f.when == "after":
            self.inner.delete_manifest(time_id)
        raise InjectedCrash(f"crash at delete_manifest[{f.when}] {time_id}")

    # -- meta ---------------------------------------------------------------
    def put_meta(self, key: str, data: bytes) -> None:
        f = self._fire("put_meta")
        if f is None:
            return self.inner.put_meta(key, data)
        if f.mode == "transient":
            raise f.exc(f"injected transient error: put_meta {key}")
        if f.mode == "torn":
            self.inner.put_meta(key, self._torn(data, f.torn_fraction))
            raise InjectedCrash(f"torn put_meta {key}")
        if f.when == "after":
            self.inner.put_meta(key, data)
        raise InjectedCrash(f"crash at put_meta[{f.when}] {key}")

    def get_meta(self, key: str) -> Optional[bytes]:
        point = "get_lease" if key == _LEASES_KEY else "get_meta"
        f = self._fire(point)
        if f is not None and f.mode == "transient":
            raise f.exc(f"injected transient error: {point} {key}")
        return self.inner.get_meta(key)

    def compare_and_put_meta(self, key: str, expected_old: Optional[bytes],
                             new: bytes) -> bool:
        f = self._fire("cas_lease" if key == _LEASES_KEY else "cas_meta")
        if f is None:
            return self.inner.compare_and_put_meta(key, expected_old, new)
        if f.mode == "transient":
            raise f.exc(f"injected transient error: cas_meta {key}")
        if f.mode == "torn":
            # the CAS itself succeeds at the backend but the blob lands
            # truncated — a torn refs write on a non-atomic backend.
            self.inner.put_meta(key, self._torn(new, f.torn_fraction))
            raise InjectedCrash(f"torn cas_meta {key}")
        if f.when == "after":
            self.inner.compare_and_put_meta(key, expected_old, new)
        raise InjectedCrash(f"crash at cas_meta[{f.when}] {key}")

    # -- debris / misc -------------------------------------------------------
    def sweep_tmp(self) -> int:
        return self.inner.sweep_tmp()

    def head(self) -> Optional[int]:
        return self.inner.head()

    def repair_head(self) -> bool:
        return self.inner.repair_head()

    def total_bytes(self) -> int:
        return self.inner.total_bytes()


# ---------------------------------------------------------------------------
# lease protocol fault injection (kill-mid-lease / renewal-loss / races)
# ---------------------------------------------------------------------------

#: every lease protocol operation the manager lands via blob CAS, in the
#: order a writer (acquire → set_intent → clear_intent, renew from the
#: heartbeat) and a sweeper (acquire → begin_sweep → end_sweep → release)
#: issue them.  ``reap`` is the takeover/fsck path.
LEASE_OPS = ("acquire", "renew", "release", "set_intent", "clear_intent",
             "begin_sweep", "end_sweep", "reap")


def lease_matrix_points() -> List[Tuple[str, str]]:
    """Every (op, when) a lease holder can be killed at, in protocol
    order.  ``before`` = the blob CAS never landed (the op is invisible
    to peers); ``after`` = it landed and the holder died immediately —
    the orphaned lease/intent/phase must expire and be reaped."""
    out: List[Tuple[str, str]] = []
    for op in ("acquire", "set_intent", "clear_intent", "renew",
               "begin_sweep", "end_sweep"):
        out.append((op, "before"))
        out.append((op, "after"))
    return out


class LeaseFaultInjector:
    """Op-level kill switch for the lease protocol.

    Plugs into ``LeaseManager(op_hook=...)``: the manager calls it as
    ``hook(op, "before")`` just before each landed blob CAS and
    ``hook(op, "after")`` right after, so arming ``("set_intent",
    "after")`` models a writer that registered its intent and died —
    exactly the orphaned-intent debris fsck must reap.  Store-level
    flavors (torn lease blob, renewal-loss, latency races) belong to
    `FaultyStore`'s ``cas_lease``/``get_lease`` points; this class
    covers the *protocol-step* axis the store wrapper cannot see.
    """

    def __init__(self) -> None:
        self._armed: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self.calls: Dict[Tuple[str, str], int] = {}

    def arm(self, op: str, when: str = "before", skip: int = 0) -> None:
        if op not in LEASE_OPS:
            raise ValueError(f"unknown lease op {op!r}")
        if when not in ("before", "after"):
            raise ValueError(f"unknown lease fault side {when!r}")
        with self._lock:
            self._armed.append({"op": op, "when": when, "skip": skip,
                                "fired": False})

    def clear(self) -> None:
        with self._lock:
            self._armed = []
            self.calls = {}

    @property
    def n_fired(self) -> int:
        with self._lock:
            return sum(1 for a in self._armed if a["fired"])

    def __call__(self, op: str, when: str) -> None:
        with self._lock:
            key = (op, when)
            i = self.calls.get(key, 0)
            self.calls[key] = i + 1
            for a in self._armed:
                if (a["op"] == op and a["when"] == when
                        and not a["fired"] and i >= a["skip"]):
                    a["fired"] = True
                    raise InjectedCrash(f"crash at lease {op}[{when}]")


# ---------------------------------------------------------------------------
# retry policy (the save write path's transient-error absorber)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RetryPolicy:
    """Exponential-backoff retry for *transient* store errors.

    Retries `OSError` (IOError is its alias) by default — the class real
    filesystems and object stores throw for recoverable conditions.
    `InjectedCrash` subclasses BaseException precisely so no retry policy
    can resurrect a dead process.  ``max_retries=0`` disables retrying.

    ``jitter`` spreads the backoff by a uniform ±fraction so N losers of
    the same CAS race don't all retry in lockstep (the thundering-herd
    fix the contention path needs); 0 keeps delays deterministic.
    """

    max_retries: int = 3
    backoff_s: float = 0.005
    multiplier: float = 2.0
    retry_on: tuple = (OSError,)
    jitter: float = 0.0

    def delay(self, attempt: int) -> float:
        """Sleep before retry number ``attempt`` (0-based): jittered
        exponential ``backoff_s * multiplier**attempt``."""
        d = self.backoff_s * (self.multiplier ** attempt)
        if self.jitter:
            import random
            d *= 1.0 + random.uniform(-self.jitter, self.jitter)
        return max(d, 0.0)


def call_with_retries(fn: Callable[[], Any], policy: RetryPolicy,
                      sleep: Callable[[float], None] = time.sleep,
                      progress: Optional[Callable[[], int]] = None
                      ) -> Tuple[Any, int]:
    """Run `fn`, retrying per `policy`.  Returns ``(result, n_retries)``;
    re-raises the last error once retries are exhausted.

    `progress`, for an `fn` that resumes where its last call stopped (a
    batch of puts), counts the steps done so far: a failure after a step
    landed starts the policy over, so each step gets the retries and
    delays it would get on its own."""
    attempt = n_retries = 0
    mark = progress() if progress is not None else 0
    while True:
        try:
            return fn(), n_retries
        except policy.retry_on:
            if progress is not None and progress() != mark:
                mark, attempt = progress(), 0     # a step landed
            if attempt >= policy.max_retries:
                raise
            sleep(policy.delay(attempt))
            attempt += 1
            n_retries += 1
