"""A steady profiler window inside a traced run, and its reduction.

The window is counted in the window loop's units (a training step, a
session's decode step): the profiler starts after `start` units of the
measured window, traces `warmup` units that are thrown away (a window's
first kernel records can go missing) and then `active` units between two
marks.  Only device operations inside the marks count.  The trace is
reduced once the measured window has closed.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .spans import PREFIX

ACTIVE = PREFIX + "active"
#: entries of each breakdown list
TOP = 10


class Tracer:
    def __init__(self, start: int, warmup: int, active: int) -> None:
        self.start, self.warmup, self.active = start, warmup, active
        self.units = 0
        self.prof = None
        self._mark = None
        self.t_active: Optional[Tuple[float, float]] = None
        # the profiler's first start loads CUPTI, which takes seconds:
        # pay it in set-up, not inside the measured window
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def tick(self) -> None:
        """One unit of the measured window is done."""
        self.units += 1
        if self.units == self.start:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
        elif self.units == self.start + self.warmup and self.prof:
            from torch.profiler import record_function
            self._mark = record_function(ACTIVE)
            self._mark.__enter__()
            self._t0 = time.perf_counter()
        elif (self.units == self.start + self.warmup + self.active
              and self._mark is not None):
            import torch
            torch.cuda.synchronize()
            self._mark.__exit__(None, None, None)
            self.t_active = (self._t0, time.perf_counter())
            self.prof.stop()
            self._mark = None

    def close(self) -> None:
        """Stop a profiler the window ended before its marks closed."""
        if self._mark is not None:
            self._mark.__exit__(None, None, None)
            self._mark = None
        if self.prof is not None and self.t_active is None:
            self.prof.stop()
            self.prof = None

    def reduce(self) -> Optional[Dict]:
        """The active range's device operations: busy seconds (the union
        of their intervals), the range's seconds, seconds and count per
        operation name, the longest idle gaps named by the benchmark span
        the host was in.  None when the range never closed."""
        if self.prof is None or self.t_active is None:
            return None
        return reduce_events(self.prof.profiler.kineto_results.events())


def reduce_events(events) -> Optional[Dict]:
    from torch.autograd import DeviceType
    mark = None
    host: List[Tuple[int, int, str]] = []
    dev: List[Tuple[int, int, str]] = []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(PREFIX):
                continue             # a host range mirrored on the device
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif name == ACTIVE:
            mark = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif name.startswith(PREFIX):
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                         name[len(PREFIX):]))
    if mark is None:
        return None
    a0, a1 = mark
    inside = [(max(s, a0), min(t, a1), n) for s, t, n in dev
              if t > a0 and s < a1]
    ops: Dict[str, List[float]] = {}
    for s, t, n in inside:
        o = ops.setdefault(n, [0, 0.0])
        o[0] += 1
        o[1] += (t - s) * 1e-9
    busy, gaps = _union(np.array([(s, t) for s, t, _ in inside],
                                 dtype=np.int64).reshape(-1, 2), a0, a1)
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    idle = [[_host_at(host, (g0 + g1) // 2), (g1 - g0) * 1e-9]
            for g0, g1 in gaps[:TOP]]
    top = sorted(ops.items(), key=lambda kv: kv[1][1], reverse=True)[:TOP]
    return {"busy_s": busy * 1e-9, "window_s": (a1 - a0) * 1e-9,
            "ops": {n: {"count": c, "s": s} for n, (c, s) in ops.items()},
            "device_ops": [[n[:160], s] for n, (_, s) in top],
            "idle_gaps": idle}


def _union(iv: np.ndarray, a0: int, a1: int
           ) -> Tuple[int, List[Tuple[int, int]]]:
    """Length of the union of intervals within [a0, a1], and the gaps
    between them."""
    if iv.size == 0:
        return 0, [(a0, a1)]
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    starts = iv[:, 0]
    new = np.ones(len(iv), dtype=bool)
    new[1:] = starts[1:] > ends[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(iv) - 1)
    seg_s, seg_e = starts[first], ends[last]
    busy = int((seg_e - seg_s).sum())
    bounds = [(a0, int(seg_s[0]))] + list(zip(seg_e[:-1].tolist(),
                                              seg_s[1:].tolist())) \
        + [(int(seg_e[-1]), a1)]
    return busy, [(g0, g1) for g0, g1 in bounds if g1 > g0]


def _host_at(host: List[Tuple[int, int, str]], t: int) -> str:
    """The innermost benchmark span the host was in at `t`."""
    best = None
    for s, e, n in host:
        if s <= t < e and (best is None or s > best[0]):
            best = (s, n)
    return best[1] if best else "outside the benchmark's spans"
