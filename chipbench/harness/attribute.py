"""What each thread of the program was doing while the card sat idle.

With its span log on, the program records its own spans
(`repro_torch.core.trace`: the stages of a save on the caller's and the
podding thread, the compiled steps) on the clock of the profiler's
events.  Each idle
interval of the device inside the marked window (the gaps between the
union of its operations' intervals, `trace._union`) is cut where any
span opens or closes, and each piece is named by the innermost
benchmark span open on the caller's thread and the innermost program
span open on each thread.  A piece with no span open on any thread is
unnamed: the host ran code that neither the benchmark nor the program
marks.

A program without spans (one older than them) has no log to enable:
`program_trace` returns None and no reading is made.

The benchmark's own runs leave the log off and read only the stage
timers each save's stats hold; `chipbench/idle_by_span.py` runs a cell,
traced, with the log on and prints what this module finds.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .spans import PREFIX
from .stats import median, percentile
from .trace import ACTIVE, TOP, _union

#: name of the caller's thread in the program's span records
CALLER = "MainThread"


def program_trace():
    """The program's span log, switched on; None where the program has
    none."""
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    trace.enable()
    return trace


def record(rec: Dict, ptrace, tracer, w0: int, w1: int) -> None:
    """Stop the span log and keep in `rec` the spans that began inside
    the window [w0, w1) (``program_spans``) and the idle time of the
    marked window by what each thread was in (``idle_attribution``)."""
    ptrace.disable()
    spans = ptrace.spans()
    rec["program_spans"] = [s for s in spans if w0 <= s["start_ns"] < w1]
    if tracer is not None and tracer.prof is not None \
            and tracer.t_active is not None:
        rec["idle_attribution"] = attribute(
            tracer.prof.profiler.kineto_results.events(), spans)


def attribute(events, spans: Sequence[Dict]) -> Optional[Dict]:
    """The marked window's idle device time: in all (``idle_s``), with
    no span open on any thread (``unnamed_s``), and by what was open
    (``top``: the longest [label, seconds]; ``threads``: per thread, the
    seconds under each innermost program span, ``-`` for none).  None
    when the window never closed."""
    from torch.autograd import DeviceType
    mark = None
    dev: List[Tuple[int, int]] = []
    bench: List[Tuple[int, int, str]] = []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(PREFIX):
                continue             # a host range mirrored on the device
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name == ACTIVE:
            mark = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif name.startswith(PREFIX):
            bench.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          name[len(PREFIX):]))
    if mark is None:
        return None
    a0, a1 = mark
    iv = np.array([(max(s, a0), min(t, a1)) for s, t in dev
                   if t > a0 and s < a1], dtype=np.int64).reshape(-1, 2)
    _, gaps = _union(iv, a0, a1)
    prog = [(s["start_ns"], s["end_ns"], s["name"], s["thread"])
            for s in spans]
    return attribute_gaps(gaps, bench, prog)


def attribute_gaps(gaps: Sequence[Tuple[int, int]],
                   bench: Sequence[Tuple[int, int, str]],
                   prog: Sequence[Tuple[int, int, str, str]]) -> Dict:
    """`attribute` on idle intervals `gaps`, benchmark spans `bench`
    (start, end, name; all on the caller's thread) and program spans
    `prog` (start, end, name, thread), all in ns on one clock."""
    lo = min((g0 for g0, _ in gaps), default=0)
    hi = max((g1 for _, g1 in gaps), default=0)
    open_ = [(s, e, n, CALLER, True) for s, e, n in bench
             if e > lo and s < hi] + \
        [(s, e, n, t, False) for s, e, n, t in prog if e > lo and s < hi]
    open_.sort(key=lambda x: x[0])
    starts = [x[0] for x in open_]
    cuts = sorted({x for s, e, *_ in open_ for x in (s, e)})
    known = {CALLER} | {x[3] for x in open_}
    idle = unnamed = 0
    labels: Dict[str, int] = {}
    threads: Dict[str, Dict[str, int]] = {}
    for g0, g1 in gaps:
        idle += g1 - g0
        # the spans that could be open in the gap began before it ended
        cands = open_[:bisect.bisect_left(starts, g1)]
        pts = [g0] + cuts[bisect.bisect_right(cuts, g0):
                          bisect.bisect_left(cuts, g1)] + [g1]
        for p, q in zip(pts, pts[1:]):
            mid = (p + q) // 2
            inner: Dict[Tuple[str, bool], Tuple[int, str]] = {}
            for s, e, n, t, is_bench in cands:
                if s <= mid < e:
                    k = (t, is_bench)
                    if k not in inner or s >= inner[k][0]:
                        inner[k] = (s, n)
            if not inner:
                unnamed += q - p
            b = inner.get((CALLER, True))
            on = sorted((t, n) for (t, is_b), (_, n) in inner.items()
                        if not is_b)
            label = " | ".join([f"bench:{b[1] if b else '-'}"]
                               + [f"{t}:{n}" for t, n in on])
            labels[label] = labels.get(label, 0) + (q - p)
            named = dict(on)
            for t in known:
                per = threads.setdefault(t, {})
                n = named.get(t, "-")
                per[n] = per.get(n, 0) + (q - p)
    top = sorted(labels.items(), key=lambda kv: kv[1], reverse=True)[:TOP]
    return {"idle_s": idle * 1e-9, "unnamed_s": unnamed * 1e-9,
            "top": [[k, v * 1e-9] for k, v in top],
            "threads": {t: {n: v * 1e-9 for n, v in sorted(
                per.items(), key=lambda kv: kv[1], reverse=True)[:TOP]}
                for t, per in threads.items()}}


#: spans of a session save whose interval only holds their children's
#: work
CONTAINERS = ("session.save", "save", "save.body", "save.commit")


def unnamed_pct(a: Optional[Dict]) -> Optional[float]:
    """Share of the marked window's idle device time with no benchmark
    span and no program span open on any thread."""
    if not a or a["idle_s"] <= 0:
        return None
    return 100.0 * a["unnamed_s"] / a["idle_s"]


def caller_unspanned_pct(a: Optional[Dict]) -> Optional[float]:
    """Share of the marked window's idle device time in which the
    caller's thread, the one that feeds the card, was in no program
    span (whatever other threads were in)."""
    if not a or a["idle_s"] <= 0:
        return None
    return 100.0 * a["threads"].get(CALLER, {}).get("-", 0.0) / a["idle_s"]


def unspanned_pct(spans: Sequence[Dict]) -> Optional[float]:
    """100 x the self time (the interval less the part its children
    cover) of every container in a ``session.save`` tree, over the summed
    duration of the ``session.save`` spans: the share of the session
    saves that no stage names."""
    kids: Dict[Optional[int], List[Dict]] = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)

    def dur(s: Dict) -> int:
        return s["end_ns"] - s["start_ns"]

    outer = [s for s in spans if s["name"] == "session.save"]
    total = sum(dur(s) for s in outer)
    if total <= 0:
        return None
    self_ns, todo = 0, list(outer)
    while todo:
        s = todo.pop()
        below = kids.get(s["id"], [])
        if s["name"] in CONTAINERS:
            self_ns += dur(s) - sum(dur(c) for c in below)
        todo.extend(below)
    return 100.0 * self_ns / total


def span_table(spans: Sequence[Dict]) -> Dict[str, Dict]:
    """Per span name: its threads, count, median and 90th percentile in
    ms, and the median share of its interval its thread spent on the
    CPU."""
    by: Dict[str, List[Dict]] = {}
    for s in spans:
        by.setdefault(s["name"], []).append(s)
    out = {}
    for name, ss in sorted(by.items()):
        ms = [(s["end_ns"] - s["start_ns"]) * 1e-6 for s in ss]
        cpu = [s["cpu_ns"] / (s["end_ns"] - s["start_ns"]) for s in ss
               if s["end_ns"] > s["start_ns"]]
        out[name] = {"threads": sorted({s["thread"] for s in ss}),
                     "n": len(ss), "median_ms": median(ms),
                     "p90_ms": percentile(ms, 90.0),
                     "cpu_share": median(cpu)}
    return out
