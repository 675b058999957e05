"""Asynchronous saving (paper §6.1–§6.2), double-buffered.

A single background *podding thread* runs the heavy half of a save
(digesting, podding, serialization, storage writes) while the training/
serving loop continues.  Two non-reentrant locks suffice (§6.2):

  * ``l_ns``     — namespace lock: makes shared host-side structures
                   (thesaurus, store indices) thread-safe;
  * ``l_active`` — held for the duration of a save over the *active*
                   variables.  It guards host-mutable state (pipeline
                   cursors) and the donation decision: a training step
                   may donate the buffers of leaves the ASCC proved
                   read-only, but must not donate active leaves while a
                   save is in flight.

Torch tensors mutate in place, so a reference to a leaf is not a
snapshot of it: `Chipmink.save` copies every tensor leaf on the caller's
current stream as the ``prepare`` step of its submit, once a pipeline
slot is free, and the body runs on a side stream that waits for that
copy (the snapshot rule in ``checkpoint.py``).  This module only
schedules bodies; it knows nothing of devices.

Double buffering (the departure from the paper's single-flight rule):
``submit`` no longer joins the previous save.  Up to ``depth`` saves may
be in flight — one running on the worker plus ``depth - 1`` queued — so
save N's decide/gather/write overlaps step N+1's compute.  Submitting
while the pipeline is full blocks until a slot frees (backpressure), and
each such block is counted in ``n_stalls``; a caller whose previous save
finishes before the next ``save()`` therefore observes zero stalls.
Save *bodies* still execute strictly FIFO on one worker thread, which is
what keeps the cross-save state (digest table, previous PodAssignment,
thesaurus) free of write races; the caller-side snapshot (graph build
and tensor copy at ``save()`` call time) is what makes the overlap
sound.

Degraded mode: a failed body does not stop the pipeline — later queued
saves still run (a transient fault should cost one checkpoint, not all
of them).  Every failure is kept: the pending list re-raises on the next
``wait()``/``submit()`` (one error as itself, several combined into
`AsyncSaveError`), and the cumulative ``n_failed`` counter survives the
drain so supervision code can account for absorbed failures.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Deque, List, Optional


class AsyncSaveError(RuntimeError):
    """More than one queued save body failed before the caller checked.

    Degraded mode: the pipeline keeps draining after a failure (later
    saves may well succeed — e.g. a transient disk error), so by the time
    `wait()`/`submit()` surfaces the problem several bodies may have
    failed.  Every underlying error is kept in ``errors``; the message
    summarizes them.  A single failure re-raises the original exception
    unchanged (type-stable for callers matching on it).
    """

    def __init__(self, errors: List[BaseException]) -> None:
        self.errors = list(errors)
        msg = "; ".join(f"{type(e).__name__}: {e}" for e in self.errors)
        super().__init__(f"{len(self.errors)} async saves failed: {msg}")


class AsyncSaver:
    def __init__(self, depth: int = 2) -> None:
        self.l_ns = threading.Lock()        # namespace lock
        self.l_active = threading.Lock()    # active-variable lock
        self.depth = max(1, int(depth))     # max saves in flight
        self._cv = threading.Condition()
        self._queue: Deque[Callable[[], Any]] = deque()
        self._inflight = 0                  # queued + running
        self._worker: Optional[threading.Thread] = None
        self._errors: List[BaseException] = []
        # contract counters (read by benchmarks/stats)
        self.n_submits = 0
        self.n_stalls = 0      # submit blocked on a full pipeline
        self.n_overlapped = 0  # submit returned while a save was in flight
        #: cumulative count of failed save bodies.  Unlike the pending
        #: error list (drained by the raise on wait()/submit()), this
        #: never resets: a caller that absorbed an error once can still
        #: see that failures happened (degraded-mode accounting).
        self.n_failed = 0

    @property
    def busy(self) -> bool:
        with self._cv:
            return self._inflight > 0

    def _drain_errors_locked(self) -> Optional[BaseException]:
        """Pop every pending error as one raisable (caller holds _cv).

        One failure re-raises the original exception; several combine
        into an `AsyncSaveError` so no secondary failure is ever lost.
        `n_failed` is NOT reset — it is the cumulative record."""
        if not self._errors:
            return None
        errs, self._errors = self._errors, []
        if len(errs) == 1:
            return errs[0]
        return AsyncSaveError(errs)

    def wait(self) -> None:
        """Join every in-flight save (and re-raise the pending errors —
        combined into `AsyncSaveError` when more than one body failed)."""
        with self._cv:
            while self._inflight > 0:
                self._cv.wait()
            err = self._drain_errors_locked()
            if err is not None:
                raise err

    def drain(self) -> List[BaseException]:
        """Join every in-flight save and RETURN the pending errors
        instead of raising — the shutdown flavor of `wait()`: a caller
        tearing down (`Chipmink.close`) must still release its leases
        and stop its heartbeat even when the last body failed.  The
        returned list is the same set `wait()` would have raised;
        ``n_failed`` still counts them."""
        with self._cv:
            while self._inflight > 0:
                self._cv.wait()
            errs, self._errors = self._errors, []
            return errs

    def submit(self, fn: Callable[[], Any],
               prepare: Optional[Callable[[], Any]] = None) -> None:
        """Enqueue `fn` on the podding thread.  Returns immediately while
        fewer than `depth` saves are in flight; otherwise blocks until the
        oldest save retires (backpressure, counted in `n_stalls`).

        `prepare` runs on the caller's thread once a slot is held and
        before `fn` is enqueued, so what it allocates (the save's
        snapshot) never lives through a stall.  If it raises, the slot is
        released and `fn` is not enqueued.

        Previously failed saves surface here (as they did when submit
        joined the prior thread): the pending errors re-raise (combined
        when several bodies failed) and `fn` is NOT enqueued, so a loop
        that only ever calls save() cannot run forever on silently
        missing checkpoints."""
        with self._cv:
            err = self._drain_errors_locked()
            if err is not None:
                raise err
            self.n_submits += 1
            if self._inflight > 0:
                self.n_overlapped += 1
            if self._inflight >= self.depth:
                self.n_stalls += 1
                while self._inflight >= self.depth:
                    self._cv.wait()
            self._inflight += 1           # the slot is held from here on
        try:
            if prepare is not None:
                prepare()
        except BaseException:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()
            raise
        with self._cv:
            self._queue.append(fn)
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._run, name="chipmink-podding", daemon=True)
                self._worker.start()
            self._cv.notify_all()

    def _run(self) -> None:
        while True:
            with self._cv:
                if not self._queue:
                    # idle: retire the worker; the next submit restarts it.
                    self._worker = None
                    self._cv.notify_all()
                    return
                fn = self._queue.popleft()
            try:
                with self.l_active:
                    fn()
            except BaseException as e:  # surfaced on next wait()/submit()
                with self._cv:
                    self._errors.append(e)
                    self.n_failed += 1
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def can_access(self, var_is_active: bool, static_execution: bool) -> bool:
        """Paper §6 access rule: during an in-flight save, an execution may
        proceed iff it touches only inactive variables or is provably
        static (ASCC)."""
        if not self.busy:
            return True
        return (not var_is_active) or static_execution
