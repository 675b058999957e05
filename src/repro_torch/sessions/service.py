"""SessionService: many live sessions time-traveling over one store.

The port of `repro.sessions.service`.  Every pool instance is a port
`Chipmink` on one device (``device="cuda"`` by default, as `Chipmink`;
pass ``device="cpu"`` to run the kernels' plain versions), and each
session's detector digests on that device.  A swapped-out session keeps
its detector, and with it its device-resident digest table
(`ChangeDetector._dev_table`, 16 bytes per bucket row of its last
save, padding included), so the device memory the service holds grows
with the number of sessions.

Kishu (PAPERS.md) is the exemplar: many live notebook sessions sharing
one checkpoint store, each with its own timeline.  Here the sessions are
*serving* sessions — per-user KV/SSM cache + request cursor — and the
store is Chipmink's content-addressed pod store, which changes the
economics in three ways:

  * **Branches are free.**  A session is just a ref (``sessions/<id>``)
    in the shared `CommitDAG`; `CommitDAG.record(branch=)` commits onto
    it without moving any instance's HEAD, so one `Chipmink` serves
    interleaved saves from any number of sessions.
  * **Cross-session dedup is free.**  Pods are content-addressed, so two
    sessions whose caches share a prompt prefix write the shared pods
    once (the second save aliases them); forking a session from another
    session's commit (`open_session(from_ref=...)`) starts at 100%
    physical sharing and diverges pod-by-pod.  `fleet_stats()` measures
    the realized dedup ratio: logical tip bytes / physical union bytes.
  * **Eviction is O(session).**  `evict_session` deletes the branch and
    reclaims its exclusive commits/pods through the persistent refcount
    index (`Chipmink.evict_branch`) — no mark-and-sweep of the whole
    fleet's store on the serving path.

What is *per-session* vs *shared* is the crux of the design.  Shared:
the store, the commit DAG, the refcount index, each pool instance's
thesaurus and async pipeline.  Per-session (swapped onto a pool
instance at each touch, captured back when the instance is rebound):
the `ChangeDetector` (device-resident digest table of the session's own
previous save), `GraphCache`, `FlipTracker`, previous `PodAssignment` /
graph / pod digests, and the head TimeID — exactly the state that makes
the next save of THAT session incremental.  A rebind drains the
instance first, so swapped-out state is never touched by an in-flight
save body.

Pool sizing: ``pool_size=1`` serializes all sessions through one
instance (every rebind to a *different* session costs a drain — fine
for benchmarks and single-threaded servers).  A larger pool keeps the
N most-recently-touched sessions bound, LRU-style round-robin, with
TimeID allocation routed through the store's CAS counter
(``shared_tids``) so instances never mint colliding commit ids.  The
service itself is not thread-safe; callers serialize access per
service (one service per serving thread/process is the intended
deployment, all of them over one shared store).

Migration: `resume_session(id)` on a *different* service instance syncs
refs, adopts the branch, and `delta_checkout`s its tip — fetching only
pods the destination's live memory doesn't already hold — then primes
the per-session incremental state so the first post-migration save is
not a from-scratch walk.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Any, Dict, List, Optional, Set, Tuple

from ..core.change_detector import ChangeDetector
from ..core.checkpoint import Chipmink, TimeID
from ..core.graph_cache import GraphCache
from ..core.store import BaseStore, MemoryStore
from ..core.trace import span
from ..core.volatility import FlipTracker

SESSION_NS = "sessions/"


@dataclasses.dataclass
class SessionContext:
    """One session's swappable incremental-pipeline state."""

    session_id: str
    branch: str
    slot: int
    head: Optional[TimeID] = None
    detector: Optional[ChangeDetector] = None
    graph_cache: Optional[GraphCache] = None
    tracker: Optional[FlipTracker] = None
    prev_pods: Any = None
    prev_graph: Any = None
    pod_digests: Dict[int, bytes] = dataclasses.field(default_factory=dict)
    n_saves: int = 0
    last_used: float = 0.0
    last_checkout_stats: Any = None


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    i = min(len(ys) - 1, max(0, int(round(q * (len(ys) - 1)))))
    return ys[i]


@dataclasses.dataclass
class FleetStats:
    n_sessions: int = 0
    n_saves: int = 0
    n_evictions: int = 0
    #: Σ per-session tip bytes — what n_sessions independent stores
    #: would hold for the same tips.
    logical_tip_bytes: int = 0
    #: bytes of the union of all tip pod digests — what the shared
    #: store actually holds for them.
    physical_tip_bytes: int = 0
    store_bytes: int = 0
    p50_save_stall_s: float = 0.0
    p99_save_stall_s: float = 0.0
    p50_evict_s: float = 0.0
    p99_evict_s: float = 0.0
    bytes_reclaimed: int = 0

    @property
    def dedup_ratio(self) -> float:
        """>1 means cross-session sharing: how many times over the
        fleet's logical state the store would have held without
        content addressing."""
        if self.physical_tip_bytes == 0:
            return 1.0
        return self.logical_tip_bytes / self.physical_tip_bytes

    @property
    def bytes_per_session(self) -> float:
        return (self.store_bytes / self.n_sessions
                if self.n_sessions else 0.0)

    def as_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d["dedup_ratio"] = self.dedup_ratio
        d["bytes_per_session"] = self.bytes_per_session
        return d


class SessionService:
    """Multiplex many serving sessions onto one shared Chipmink store."""

    def __init__(self, store: Optional[BaseStore] = None, *,
                 pool_size: int = 1,
                 fsck_on_open: Any = True,
                 **chipmink_kwargs: Any) -> None:
        """``chipmink_kwargs`` configure every pool instance (chunk_bytes,
        async_mode, delta_chains, ...).  ``refcounts`` is forced on (the
        eviction path requires it); ``shared_tids`` is forced on for
        pools > 1.  Only the first instance runs the on-open fsck — the
        rest open the store the first one already repaired."""
        if pool_size < 1:
            raise ValueError("pool_size must be >= 1")
        self.store = store if store is not None else MemoryStore()
        chipmink_kwargs.pop("refcounts", None)
        shared = chipmink_kwargs.pop("shared_tids", pool_size > 1)
        self.pool: List[Chipmink] = []
        for i in range(pool_size):
            self.pool.append(Chipmink(
                self.store, refcounts=True, shared_tids=shared,
                fsck_on_open=(fsck_on_open if i == 0 else False),
                **chipmink_kwargs))
        self.sessions: Dict[str, SessionContext] = {}
        #: slot -> session id currently installed on that pool instance
        self._bound: List[Optional[str]] = [None] * pool_size
        self._rr = 0
        self.save_stalls: List[float] = []
        self.evict_latencies: List[float] = []
        self.n_evictions = 0
        self.bytes_reclaimed = 0

    # ------------------------------------------------------------------
    # binding: swap per-session pipeline state onto a pool instance
    # ------------------------------------------------------------------
    def _fresh_state(self, ck: Chipmink) -> Tuple[ChangeDetector,
                                                  Optional[GraphCache],
                                                  Optional[FlipTracker]]:
        d = ck.detector
        det = ChangeDetector(chunk_bytes=d.chunk_bytes, seed=d.seed,
                             batched=d.batched, fused=d.fused,
                             device=d.device)
        cache = (GraphCache(chunk_bytes=ck.chunk_bytes)
                 if ck.incremental else None)
        tracker = FlipTracker() if ck.tracker is not None else None
        return det, cache, tracker

    def _capture(self, slot: int) -> None:
        """Save the bound session's pipeline state back into its ctx.
        Caller must have drained the instance."""
        sid = self._bound[slot]
        if sid is None:
            return
        ctx = self.sessions.get(sid)
        ck = self.pool[slot]
        if ctx is not None:
            ctx.detector = ck.detector
            ctx.graph_cache = ck._graph_cache
            ctx.tracker = ck.tracker
            ctx.prev_pods = ck._prev_pods
            ctx.prev_graph = ck._prev_graph
            ctx.pod_digests = ck._pod_digests
            ctx.head = ck._head
        self._bound[slot] = None

    def _install(self, ctx: SessionContext) -> Chipmink:
        ck = self.pool[ctx.slot]
        if ctx.detector is None:
            ctx.detector, ctx.graph_cache, ctx.tracker = \
                self._fresh_state(ck)
        ck.detector = ctx.detector
        ck.fused = ctx.detector.fused
        ck._graph_cache = ctx.graph_cache
        ck.tracker = ctx.tracker
        ck._prev_pods = ctx.prev_pods
        ck._prev_graph = ctx.prev_graph
        ck._pod_digests = ctx.pod_digests
        ck._head = ctx.head
        self._bound[ctx.slot] = ctx.session_id
        return ck

    def _bind(self, ctx: SessionContext) -> Chipmink:
        """Make `ctx`'s pool instance ready for this session: no-op when
        already bound (the hot path — a session saving repeatedly on its
        slot pays zero swap cost); otherwise drain, capture the previous
        tenant, install this one."""
        if self._bound[ctx.slot] == ctx.session_id:
            return self.pool[ctx.slot]
        ck = self.pool[ctx.slot]
        ck.wait()
        self._capture(ctx.slot)
        return self._install(ctx)

    # ------------------------------------------------------------------
    # session lifecycle
    # ------------------------------------------------------------------
    def open_session(self, session_id: str,
                     from_ref: Any = None) -> SessionContext:
        """Register a new session.  With ``from_ref`` (a TimeID, another
        session's branch name, or a tag) the session forks from that
        commit — its first save starts at 100% physical sharing with the
        parent.  Without it the session starts empty (its first save is
        a root commit that creates the branch)."""
        if session_id in self.sessions:
            raise ValueError(f"session {session_id!r} already open")
        branch = SESSION_NS + session_id
        ck0 = self.pool[0]
        # a peer instance (or pool sibling) may have created branches
        # this instance's DAG hasn't seen: refs are the truth.
        ck0.versions.sync()
        if branch in ck0.versions.branches:
            raise ValueError(
                f"branch {branch!r} already exists in the store — "
                "use resume_session to adopt it")
        slot = self._rr % len(self.pool)
        self._rr += 1
        ctx = SessionContext(session_id=session_id, branch=branch,
                             slot=slot, last_used=_time.time())
        if from_ref is not None:
            ck0.wait()
            with ck0.saver.l_ns:
                tid = ck0.versions.create_branch(branch, at=from_ref,
                                                 switch=False)
            ctx.head = tid
        self.sessions[session_id] = ctx
        return ctx

    def save_session(self, session_id: str, state: Any,
                     **save_kwargs: Any) -> TimeID:
        """Checkpoint one session's serving state: a commit on its
        branch, chained to its previous save, through the full
        incremental pipeline.  The wall time of this call is the
        *save stall* — what the serving loop actually blocks for
        (with ``async_mode`` the body overlaps the next request): the
        span ``session.save``."""
        ctx = self.sessions[session_id]
        ck = self._bind(ctx)
        with span("session.save", session=session_id) as sp:
            tid = ck.save(state, parent=ctx.head, branch=ctx.branch,
                          **save_kwargs)
        self.save_stalls.append(sp.seconds)
        ctx.head = tid
        ctx.n_saves += 1
        ctx.last_used = _time.time()
        return tid

    def resume_session(self, session_id: str) -> Any:
        """Adopt an existing session branch and restore its tip — the
        migration path: a branch committed by another service instance
        (or a previous life of this one) becomes live here, delta-aware
        (only pods absent from this instance's live memory are read),
        with the incremental pipeline primed so the next save is not
        from-scratch.  Returns the restored state tree."""
        from ..version import delta_checkout
        branch = SESSION_NS + session_id
        ctx = self.sessions.get(session_id)
        if ctx is None:
            slot = self._rr % len(self.pool)
            self._rr += 1
            ctx = SessionContext(session_id=session_id, branch=branch,
                                 slot=slot)
        ck = self.pool[ctx.slot]
        ck.wait()
        # another instance may have advanced (or created) the branch:
        # refs are the cross-instance truth.
        ck.versions.sync()
        tip = ck.versions.branches.get(branch)
        if tip is None:
            self.sessions.pop(session_id, None)
            raise KeyError(f"no such session branch {branch!r}")
        self._capture(ctx.slot)
        # checkout primes the INSTANCE's pipeline state; install fresh
        # state first so it primes this session's, not a stale tenant's.
        ctx.detector, ctx.graph_cache, ctx.tracker = self._fresh_state(ck)
        ctx.prev_pods = ctx.prev_graph = None
        ctx.pod_digests = {}
        ctx.head = tip
        self._install(ctx)
        state, stats = delta_checkout(ck, tip)
        ck._head = tip
        # checkout mutated the installed detector/cache in place and
        # replaced the assignment-side attrs: pull those back into ctx.
        ctx.prev_pods = ck._prev_pods
        ctx.prev_graph = ck._prev_graph
        ctx.pod_digests = ck._pod_digests
        ctx.last_used = _time.time()
        ctx.last_checkout_stats = stats
        self.sessions[ctx.session_id] = ctx
        return state

    def evict_session(self, session_id: str) -> Any:
        """Delete the session's branch and reclaim its exclusive bytes,
        in O(session delta) via the refcount index.  Returns the
        `GCStats` of the reclaim."""
        ctx = self.sessions.pop(session_id)
        t0 = _time.perf_counter()
        # drain every instance: an in-flight save on ANY slot may still
        # be committing onto this branch's lineage or aliasing its pods.
        for ck in self.pool:
            ck.wait()
        if self._bound[ctx.slot] == session_id:
            # discard, don't capture: the state dies with the branch.
            self._bound[ctx.slot] = None
            ck = self.pool[ctx.slot]
            ck._prev_pods = None
            ck._prev_graph = None
            ck._pod_digests = {}
            if ck._graph_cache is not None:
                ck._graph_cache.invalidate()
            ck._head = None
        stats = self.pool[0].evict_branch(ctx.branch)
        if stats.deleted_pod_digests:
            # evict_branch pruned instance 0's thesaurus; the others
            # must not alias reclaimed digests either.
            for ck in self.pool[1:]:
                ck.thesaurus.prune(stats.deleted_pod_digests)
        self.evict_latencies.append(_time.perf_counter() - t0)
        self.n_evictions += 1
        self.bytes_reclaimed += stats.bytes_reclaimed
        return stats

    def evict_idle(self, max_idle_s: float,
                   now: Optional[float] = None) -> List[str]:
        """Evict every session idle longer than ``max_idle_s``; returns
        the evicted ids."""
        now = _time.time() if now is None else now
        idle = [sid for sid, ctx in self.sessions.items()
                if now - ctx.last_used > max_idle_s]
        for sid in idle:
            self.evict_session(sid)
        return idle

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def session_ids(self) -> List[str]:
        return sorted(self.sessions)

    def fleet_stats(self) -> FleetStats:
        """Fleet-wide roll-up; the dedup ratio compares what every live
        session's tip would cost stored independently (logical) against
        the shared store's union (physical)."""
        ck0 = self.pool[0]
        stats = FleetStats(n_sessions=len(self.sessions),
                           n_saves=len(self.save_stalls),
                           n_evictions=self.n_evictions,
                           bytes_reclaimed=self.bytes_reclaimed)
        union: Set[str] = set()
        for ctx in self.sessions.values():
            tip = ctx.head
            if tip is None:
                continue
            digs = ck0.versions.pod_digests_of(tip, missing_ok=True)
            stats.logical_tip_bytes += sum(
                self.store.pod_nbytes(d) for d in digs)
            union |= digs
        stats.physical_tip_bytes = sum(
            self.store.pod_nbytes(d) for d in union)
        stats.store_bytes = self.store.total_bytes()
        stats.p50_save_stall_s = _percentile(self.save_stalls, 0.50)
        stats.p99_save_stall_s = _percentile(self.save_stalls, 0.99)
        stats.p50_evict_s = _percentile(self.evict_latencies, 0.50)
        stats.p99_evict_s = _percentile(self.evict_latencies, 0.99)
        return stats

    def close(self) -> List[BaseException]:
        errors: List[BaseException] = []
        for ck in self.pool:
            errors.extend(ck.close())
        return errors
