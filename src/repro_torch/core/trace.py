"""Spans: the stage timers of a save and of the compiled steps.

    with span("save.digest", stats, "t_digest"):
        ...

A span given `stats` always writes ``stats[key]``, the seconds of its
interval by the performance counter, as a stage timer does.  With
tracing enabled (`enable()`; off by default) it also appends one record
to an in-memory log of at most `LIMIT` records (the oldest drop out),
read by `spans()`:

    id, name, thread   the span, and the name of the thread it ran on
    start_ns, end_ns   its interval on `clock_ns`: the performance
                       counter moved onto the Unix-epoch nanoseconds the
                       profiler (`torch.profiler`) stamps its host and
                       device events with (`KinetoEvent.start_ns`), by one
                       offset taken at `enable()`; ``end_ns - start_ns``
                       is the ``stats[key]`` the span wrote
    cpu_ns             the thread's CPU time over the interval
                       (`time.thread_time_ns`): the rest of the interval
                       the thread waited (the interpreter lock, a lock, a
                       blocking fetch, the scheduler)
    parent             the id of the span it ran inside: the innermost
                       span open on its thread, or the span named by
                       ``parent=`` (a save body runs on the podding thread
                       inside the caller's ``save``)
    time_id, session   the save's TimeID and the serving session: the
                       span's own (``span.time_id``, ``session=``) or
                       its parent's

A span given `cpu_key` also writes ``stats[cpu_key]``, the thread's CPU
seconds over its interval, tracing or not (``save.body`` is the one; two
reads of the thread's CPU clock a save).

With tracing off any other span reads the performance counter twice and
writes its key, as the timer pair it replaces did: no record, no
thread-state update and no CPU clock.

Span names of a save (``t_*`` keys of ``Chipmink.save_stats`` beside
them)::

    session.save                  SessionService.save_session (save_stalls)
      save                        Chipmink.save
        save.graph                t_graph
        save.slot_wait            t_slot_wait   (async: a free pipeline slot)
        save.snapshot             t_snapshot    (async: the tensor copy)
        save.body                 t_body, t_body_cpu (podding thread if async)
          save.avf                t_avf
          save.digest             t_digest
            save.digest.call      t_digest_call (the digest kernels' call)
          save.track              t_track
          save.podding            t_podding
          save.decide             t_decide
          save.intent             t_intent      (multi-writer only)
          save.gather             t_gather
          save.write              t_write
            save.write.pack       t_write_pack  (summed over batches)
              save.write.delta    t_delta_encode (summed over pods)
            save.write.put        t_write_put   (summed over batches)
          save.commit             t_commit
            save.commit.manifest  t_commit_manifest
            save.commit.refcounts t_commit_refcounts
            save.commit.refs      t_commit_refs
    train.step                    TrainGraph.__call__ (host enqueue)
    decode.step                   DecodeGraph.__call__ (host enqueue)
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Deque, Dict, List, Optional

#: records the log keeps
LIMIT = 1 << 16

_on = False
_log: Deque[Dict[str, Any]] = collections.deque(maxlen=LIMIT)
_ids = itertools.count(1)
_local = threading.local()
_perf_ns = time.perf_counter_ns


def _unix_offset() -> int:
    """Unix-epoch ns minus performance-counter ns, from the closest of a
    few paired reads."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


_offset = _unix_offset()


def clock_ns() -> int:
    """Now, on the clock of the span records."""
    return time.perf_counter_ns() + _offset


def enable() -> None:
    """Record every span from now on, into a fresh log of at most
    `LIMIT` records."""
    global _on, _log, _offset
    _log = collections.deque(maxlen=LIMIT)
    _offset = _unix_offset()
    _on = True


def disable() -> None:
    """Stop recording; the log stays readable."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def spans() -> List[Dict[str, Any]]:
    """The recorded spans, in the order they ended."""
    return list(_log)


def _stack() -> List["span"]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class span:
    """A stage of the program's work; see the module docstring.  After
    the ``with`` block, ``seconds`` holds its duration."""

    __slots__ = ("name", "stats", "key", "cpu_key", "parent", "time_id",
                 "session", "seconds", "_t0", "_rec", "_cpu0")

    def __init__(self, name: str, stats: Optional[Dict[str, Any]] = None,
                 key: Optional[str] = None, *, cpu_key: Optional[str] = None,
                 parent: Optional["span"] = None,
                 session: Any = None) -> None:
        self.name, self.stats, self.key = name, stats, key
        self.cpu_key, self.parent = cpu_key, parent
        #: the save's TimeID, set by the caller once it has one
        self.time_id, self.session = None, session
        self.seconds = 0.0
        self._rec: Optional[Dict[str, Any]] = None

    def __enter__(self) -> "span":
        if _on:
            st = _stack()
            up = self.parent if self.parent is not None else (
                st[-1] if st else None)
            rec = {"id": next(_ids), "name": self.name,
                   "thread": threading.current_thread().name,
                   "parent": None}
            if up is not None:
                if up._rec is not None:
                    rec["parent"] = up._rec["id"]
                if self.time_id is None:
                    self.time_id = up.time_id
                if self.session is None:
                    self.session = up.session
            self._rec = rec
            st.append(self)
        if self._rec is not None or self.cpu_key is not None:
            self._cpu0 = time.thread_time_ns()
        self._t0 = _perf_ns()
        return self

    def __exit__(self, *exc: Any) -> None:
        t1 = _perf_ns()
        self.seconds = (t1 - self._t0) * 1e-9
        if self.stats is not None:
            self.stats[self.key] = self.seconds
        rec = self._rec
        if rec is not None or self.cpu_key is not None:
            cpu = time.thread_time_ns() - self._cpu0
            if self.cpu_key is not None:
                self.stats[self.cpu_key] = cpu * 1e-9
        if rec is not None:
            rec.update(start_ns=self._t0 + _offset, end_ns=t1 + _offset,
                       cpu_ns=cpu, time_id=self.time_id,
                       session=self.session)
            st = _stack()
            if st and st[-1] is self:
                st.pop()
            _log.append(rec)
