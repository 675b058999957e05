"""Fault tolerance: checkpoint/restart and straggler mitigation.  The
port of `repro.runtime.fault_tolerance`.

Chipmink *is* the checkpoint story: incremental, content-addressed,
deduped saves make frequent checkpointing cheap (the paper's thesis), so
the mean work lost to a failure is minutes, not hours.

`StragglerMonitor` implements the standard per-step timing discipline:
track per-host step durations, flag hosts slower than `k × median` over a
window, and recommend exclusion.  On a real fleet the timings come from
cross-host telemetry; here they are injected (simulated) — the detection
logic is what's under test.

The reference's `elastic_restore` re-shards loaded state onto a mesh and
waits for the mesh (ROADMAP.md section 1, item 4).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.checkpoint import Chipmink, TimeID


# ---------------------------------------------------------------------------
# straggler mitigation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerReport:
    stragglers: List[int]
    medians: Dict[int, float]
    global_median: float


class StragglerMonitor:
    def __init__(self, *, window: int = 16, threshold: float = 1.5,
                 min_samples: int = 8):
        self.window = window
        self.threshold = threshold
        self.min_samples = min_samples
        self._times: Dict[int, deque] = defaultdict(
            lambda: deque(maxlen=window))

    def record(self, host: int, step_seconds: float) -> None:
        self._times[host].append(step_seconds)

    def report(self) -> StragglerReport:
        medians = {h: float(np.median(t)) for h, t in self._times.items()
                   if len(t) >= self.min_samples}
        if not medians:
            return StragglerReport([], {}, 0.0)
        gm = float(np.median(list(medians.values())))
        stragglers = [h for h, m in medians.items()
                      if m > self.threshold * gm]
        return StragglerReport(sorted(stragglers), medians, gm)

    def healthy_hosts(self, hosts: Sequence[int]) -> List[int]:
        bad = set(self.report().stragglers)
        return [h for h in hosts if h not in bad]


# ---------------------------------------------------------------------------
# supervised training loop with restart
# ---------------------------------------------------------------------------

class TrainingSupervisor:
    """Run a step function under checkpoint/restart supervision.

    * saves through Chipmink every `save_every` steps (async by default),
    * on a step failure (injected or real), drains the pipeline
      (absorbing failed-save errors into ``stats["save_errors"]`` —
      degraded mode: a broken save must not take down the restart path
      that exists to recover from it), runs `Chipmink.fsck` so a save
      torn by the failure is rolled back, then reloads the newest commit
      fsck vouches for and resumes — the data pipeline cursor is part of
      the saved state, so the token stream realigns exactly,
    * `max_restarts` bounds crash loops.
    """

    def __init__(self, ck: Chipmink, *, save_every: int = 10,
                 max_restarts: int = 8):
        self.ck = ck
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.restarts = 0
        self.saves: List[TimeID] = []

    def run(self, state: Dict, n_steps: int,
            step_fn: Callable[[Dict, int], Dict],
            *, make_snapshot: Callable[[Dict], Dict],
            restore: Callable[[Dict], Dict],
            touched: Optional[Callable[[Dict], Optional[List[str]]]] = None,
            fail_at: Optional[Set[int]] = None) -> Tuple[Dict, Dict]:
        """`step_fn(state, i) -> state`; `make_snapshot` converts live
        state to the Chipmink namespace; `restore` converts back.
        `fail_at` injects failures at given step indices (testing)."""
        stats = {"failures": 0, "resumed_from": [], "save_errors": 0}
        i = 0
        failed_once: Set[int] = set()
        while i < n_steps:
            try:
                if fail_at and i in fail_at and i not in failed_once:
                    failed_once.add(i)
                    raise RuntimeError(f"injected failure at step {i}")
                state = step_fn(state, i)
                i += 1
                if i % self.save_every == 0 or i == n_steps:
                    snap = make_snapshot(state)
                    tp = touched(state) if touched else None
                    tid = self.ck.save(snap, touched_prefixes=tp)
                    self.saves.append(tid)
            except Exception:
                stats["failures"] += 1
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                # drain the pipeline, absorbing async save failures: on
                # the restart path a lost checkpoint costs re-done steps,
                # not correctness (degraded mode; n_failed keeps count).
                try:
                    self.ck.wait()
                except Exception:
                    stats["save_errors"] += 1
                # recovery scan: roll back any save the failure tore,
                # then resume from the newest commit fsck vouches for.
                self.ck.fsck()
                head = self.ck.versions.head_commit()
                self.saves = [t for t in self.saves
                              if head is not None and t <= head]
                if not self.saves:
                    # nothing (surviving) saved yet: restart from step 0
                    continue
                loaded = self.ck.load(time_id=self.saves[-1])
                state = restore(loaded)
                i = int(loaded.get("step", i))
                stats["resumed_from"].append(i)
        self.ck.wait()
        return state, stats
