"""The readers of the program's stage timers, and the idle device time
its spans name (`harness/attribute.py`, `idle_by_span.py`), on synthetic
records, intervals and profiler events; a traced run of each cell on the
CPU, where the timers are read, and a run with the span log on."""
import time
import types

import pytest

from chipbench import idle_by_span
from chipbench.harness import attribute, bench
from chipbench.harness.spans import PREFIX
from chipbench.harness.stats import median, percentile
from chipbench.harness.trace import ACTIVE

from .test_chipbench_stats import metric
from .tiny import SERVE, TRAIN, tiny_cell

#: the per-layer metrics that read the program's spans and timers
SPAN_METRICS = {TRAIN: ["commit_ms.train", "digest_call_ms.train",
                        "slot_wait_ms.train", "body_offcpu_pct.train"],
                SERVE: ["commit_ms.serve", "digest_call_ms.serve",
                        "session_save_unspanned_pct.serve"]}


def span(i, name, start, end, parent=None, thread="MainThread"):
    return {"id": i, "name": name, "start_ns": start, "end_ns": end,
            "parent": parent, "thread": thread}


@pytest.mark.parametrize("name,key", [
    ("commit_ms.train", "t_commit"), ("commit_ms.serve", "t_commit"),
    ("digest_call_ms.train", "t_digest_call"),
    ("digest_call_ms.serve", "t_digest_call")])
def test_stage_readers_take_the_median_over_the_saves(name, key):
    vals = [0.004, 0.001, 0.002, 0.010]
    rec = {"save_stats": [{key: v} for v in vals] + [{"t_graph": 1.0}]}
    assert metric(name)(rec) == pytest.approx(median(vals) * 1e3)
    # a program older than the timer: nothing to read
    assert metric(name)({"save_stats": [{"t_graph": 1.0}]}) is None
    assert metric(name)({}) is None


def test_slot_wait_is_the_p90_over_the_saves():
    waits = [0.0, 0.0, 0.001, 0.0, 0.2, 0.0, 0.0, 0.003, 0.0, 0.05]
    rec = {"save_stats": [{"t_slot_wait": w} for w in waits]}
    assert metric("slot_wait_ms.train")(rec) == pytest.approx(
        percentile([w * 1e3 for w in waits], 90))
    assert metric("slot_wait_ms.train")({"save_stats": [{}]}) is None


def test_body_off_cpu_pools_every_body():
    rec = {"save_stats": [{"t_body": 1.0, "t_body_cpu": 0.5},
                          {"t_body": 3.0, "t_body_cpu": 2.9},
                          {"t_body": 9.0}]}       # no CPU timer
    assert metric("body_offcpu_pct.train")(rec) == pytest.approx(
        100 * (4.0 - 3.4) / 4.0)
    assert metric("body_offcpu_pct.train")({"save_stats": []}) is None


def stage_stats(graph, body=(), commit=(), **more):
    """A save's stats: the caller's graph timer, the body's stage timers
    `body` (avf, digest, ..., write) and the commit's three `commit`."""
    keys = ("t_avf", "t_digest", "t_track", "t_podding", "t_decide",
            "t_gather", "t_write")
    return {"t_graph": graph, **dict(zip(keys, body)),
            **dict(zip(("t_commit_manifest", "t_commit_refcounts",
                        "t_commit_refs"), commit)), **more}


def test_unspanned_reads_the_stall_less_its_stages():
    read = metric("session_save_unspanned_pct.serve")
    sync = stage_stats(0.1, [0.01, 0.2, 0.05, 0.06, 0.01, 0.02, 0.05],
                       [0.03, 0.08, 0.01], t_body=0.55, t_commit=0.13)
    # an async save: its body is not inside the stall
    late = stage_stats(0.1, [1.0] * 7, [1.0] * 3, t_slot_wait=0.02,
                       t_snapshot=0.03)
    rec = {"save_stalls_s": [0.7, 0.2], "save_stats": [sync, late]}
    named = 0.1 + 0.40 + 0.12 + 0.1 + 0.02 + 0.03
    assert read(rec) == pytest.approx(100 * (0.9 - named) / 0.9)
    # a program older than the commit's timers: nothing to read
    old = {k: v for k, v in sync.items() if k != "t_commit_refs"}
    assert read({"save_stalls_s": [0.7], "save_stats": [old]}) is None
    assert read({"save_stalls_s": [], "save_stats": [sync]}) is None
    assert read({}) is None


def test_unspanned_counts_the_self_time_of_containers_only():
    spans = [
        span(1, "session.save", 0, 1000),
        span(2, "save", 10, 990, 1),
        span(3, "save.graph", 10, 100, 2),
        span(4, "save.body", 100, 980, 2),
        span(5, "save.digest", 100, 500, 4),     # self time 300: named
        span(6, "save.digest.call", 100, 200, 5),
        span(7, "save.commit", 520, 960, 4),
        span(8, "save.commit.refs", 540, 940, 7),
        span(9, "session.save", 2000, 2100),     # no children: all unnamed
        span(10, "decode.step", 1500, 1600),     # outside every save
    ]
    # session.save 20 + save 10 + save.body 40 + save.commit 40 + 100
    assert attribute.unspanned_pct(spans) == pytest.approx(100 * 210 / 1100)
    assert attribute.unspanned_pct(spans[-1:]) is None


@pytest.mark.parametrize("name,share", [
    ("unnamed_pct", 25.0), ("caller_unspanned_pct", 60.0)])
def test_idle_unnamed_reads_the_attribution(name, share):
    read = getattr(attribute, name)
    assert read({"idle_s": 2.0, "unnamed_s": 0.5, "threads": {
        "MainThread": {"-": 1.2, "train.step": 0.8}}}) == \
        pytest.approx(share)
    assert read(None) is None
    assert read({"idle_s": 0.0, "unnamed_s": 0.0, "threads": {}}) is None


def test_attribute_names_each_piece_of_each_gap():
    gaps = [(0, 100), (200, 300), (400, 410)]
    bench_spans = [(0, 50, "step"), (390, 420, "save")]
    prog = [(40, 250, "save.body", "chipmink-podding"),
            (60, 240, "save.write", "chipmink-podding"),
            (20, 45, "train.step", "MainThread")]
    a = attribute.attribute_gaps(gaps, bench_spans, prog)
    assert a["idle_s"] == pytest.approx(210e-9)
    # 250..300 of the second gap: nothing open anywhere
    assert a["unnamed_s"] == pytest.approx(50e-9)
    top = dict(a["top"])
    assert top["bench:- | chipmink-podding:save.write"] == \
        pytest.approx((100 - 60 + 240 - 200) * 1e-9)
    assert top["bench:step | MainThread:train.step"] == \
        pytest.approx((40 - 20) * 1e-9)
    assert top["bench:step | MainThread:train.step | "
               "chipmink-podding:save.body"] == pytest.approx(5e-9)
    assert top["bench:save"] == pytest.approx(10e-9)
    assert top["bench:-"] == pytest.approx(50e-9)
    assert sum(top.values()) == pytest.approx(a["idle_s"])
    pod = a["threads"]["chipmink-podding"]
    assert pod["save.write"] == pytest.approx(80e-9)
    assert pod["save.body"] == pytest.approx(30e-9)
    assert sum(pod.values()) == pytest.approx(a["idle_s"])
    assert a["threads"]["MainThread"]["train.step"] == pytest.approx(25e-9)


class Event:
    """The part of a profiler event `attribute` reads."""

    def __init__(self, name, start, end, cuda=False):
        from torch.autograd import DeviceType
        self._n, self._s, self._d = name, start, end - start
        self._t = DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._t

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return False


def test_attribute_reads_the_marked_window_of_a_trace():
    events = [Event(ACTIVE, 100, 1100),
              Event(PREFIX + "step", 100, 600),
              Event(PREFIX + "save", 600, 1100),
              Event(PREFIX + "step", 0, 90, cuda=True),   # a mirrored range
              Event("gemm", 50, 400, cuda=True),     # clipped at the mark
              Event("gemm", 350, 500, cuda=True),
              Event("leaves_cmp_kernel", 900, 950, cuda=True)]
    prog = [span(1, "save.digest.call", 880, 990)]
    a = attribute.attribute(events, prog)
    assert a["idle_s"] == pytest.approx((900 - 500 + 1100 - 950) * 1e-9)
    assert a["unnamed_s"] == 0
    top = dict(a["top"])
    assert top["bench:step"] == pytest.approx(100e-9)
    assert top["bench:save | MainThread:save.digest.call"] == \
        pytest.approx((900 - 880 + 990 - 950) * 1e-9)
    assert attribute.attribute(events[1:], prog) is None


def test_record_keeps_the_window_and_stops_the_log():
    log = [span(1, "save", 5, 8), span(2, "save", 10, 20),
           span(3, "decode.step", 30, 31)]
    state = {"on": True}
    ptrace = types.SimpleNamespace(
        spans=lambda: list(log),
        disable=lambda: state.update(on=False))
    rec = {}
    attribute.record(rec, ptrace, None, 10, 30)
    assert [s["id"] for s in rec["program_spans"]] == [2]
    assert "idle_attribution" not in rec and not state["on"]


@pytest.mark.parametrize("cell_name", [TRAIN, SERVE])
def test_a_traced_run_on_the_cpu_reads_the_programs_spans(
        tiny_root, monkeypatch, cell_name):
    """With ``--trace 1`` the window loops record the program's spans: every
    span and timer metric reads a number; the device's need a card."""
    from repro_torch.core import trace
    monkeypatch.setattr(bench.Run, "tracer", lambda self: None)
    cell = tiny_cell(tiny_root, cell_name)
    out = bench.run_cell(cell, 2**31 + 7, 3.0, True, "cpu",
                         time.perf_counter())
    assert not trace.enabled()
    for name in SPAN_METRICS[cell_name]:
        v = out["metrics"][name]["value"]
        assert v >= 0 and (not name.endswith("_pct") or v <= 100), name


@pytest.mark.parametrize("cell_name", [TRAIN, SERVE])
def test_a_run_with_the_span_log_names_its_threads(
        tiny_root, monkeypatch, cell_name):
    """`idle_by_span` on the CPU: the window's spans are kept, by thread
    (an async save's body on the podding thread), and the session saves'
    unnamed share read from the spans is the one the stage timers give."""
    from repro_torch.core import trace
    monkeypatch.setattr(bench.Run, "tracer", lambda self: None)
    cell = tiny_cell(tiny_root, cell_name)
    rec = idle_by_span.spanned_record(cell, 2**31 + 11, 3.0, "cpu")
    assert not trace.enabled() and "idle_attribution" not in rec
    out = idle_by_span.summary(cell, rec)
    assert out["idle_unnamed_pct"] is None and out["idle"] is None
    table = out["spans"]
    # an async body that begins after the window's close is not its
    assert 0 < table["save.body"]["n"] <= len(rec["save_stats"])
    # the thread's CPU clock and the performance counter tick apart
    assert 0 < table["save.body"]["cpu_share"] < 1.05
    if cell_name == TRAIN:
        assert table["save.body"]["threads"] == ["chipmink-podding"]
        assert table["train.step"]["threads"] == ["MainThread"]
        assert out["session_save_unspanned_pct"] is None
    else:
        assert table["session.save"]["n"] == len(rec["save_stalls_s"])
        assert out["session_save_unspanned_pct"] == pytest.approx(
            out["metrics"]["session_save_unspanned_pct.serve"], abs=1e-6)
