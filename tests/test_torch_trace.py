"""Spans of a save (`repro_torch.core.trace`) on the CPU: the tree of a
sync save, an async save and a `save_session`, the ``t_*`` stage timers
each span writes, how much of a body and of a session save the named
stages cover, and a log that stays empty with tracing off.

Imports no JAX and nothing of the reference.  Every test leaves tracing
off (the `tracing` fixture)."""
from statistics import median

import pytest
import torch

from repro_torch.core import Chipmink, MemoryStore, trace
from repro_torch.sessions import SessionService

#: span name -> the key of `save_stats` it writes
KEYS = {"save.graph": "t_graph", "save.slot_wait": "t_slot_wait",
        "save.snapshot": "t_snapshot", "save.body": "t_body",
        "save.avf": "t_avf", "save.digest": "t_digest",
        "save.digest.call": "t_digest_call", "save.track": "t_track",
        "save.podding": "t_podding", "save.decide": "t_decide",
        "save.intent": "t_intent", "save.gather": "t_gather",
        "save.write": "t_write", "save.commit": "t_commit",
        "save.commit.manifest": "t_commit_manifest",
        "save.commit.refcounts": "t_commit_refcounts",
        "save.commit.refs": "t_commit_refs"}
#: span name -> the key of `save_stats` that sums its spans' durations
#: (one span a batch of the write phase)
SUMMED = {"save.write.pack": "t_write_pack", "save.write.put": "t_write_put"}
BODY = ["save.avf", "save.digest", "save.track", "save.podding",
        "save.decide", "save.gather", "save.write", "save.commit"]
COMMIT = ["save.commit.manifest", "save.commit.refs"]
#: keys no reader reads, gone from the stats and the manifests
REMOVED = ("t_graph_inc", "n_nodes_reused", "n_nodes_rebuilt",
           "n_fused_rows", "n_pod_digests_reused")
#: the least share of a span's interval its children must cover
COVER = 0.95


@pytest.fixture
def tracing():
    trace.enable()
    yield
    trace.disable()


def make_state(seed=0, rows=512):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(rows, 256, generator=g),
                       "b": torch.randn(rows, generator=g)},
            "opt": {"mu": torch.zeros(rows, 256)},
            "step": 0}


def step(state, k):
    """A sparse update, in place, as a training step makes one."""
    state["params"]["w"][k % 16].add_(1.0)
    state["opt"]["mu"][k % 16].add_(0.5)
    state["step"] = k


def trees(records):
    """{id: record} and {id: [child records]} of the log."""
    by_id = {r["id"]: r for r in records}
    kids = {}
    for r in records:
        kids.setdefault(r["parent"], []).append(r)
    return by_id, kids


def dur(r):
    return r["end_ns"] - r["start_ns"]


def covered(r, kids):
    """Share of `r`'s interval its children cover."""
    return sum(dur(c) for c in kids.get(r["id"], [])) / dur(r)


def saves(ck, state, n):
    for k in range(n):
        if k:
            step(state, k)
        ck.save(state)
    ck.wait()


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_the_span_tree_of_a_save(tracing, async_mode):
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 12, device="cpu",
                  async_mode=async_mode)
    saves(ck, make_state(), 3)
    by_id, kids = trees(trace.spans())
    roots = [r for r in trace.spans() if r["name"] == "save"]
    assert [r["time_id"] for r in roots] == [1, 2, 3]
    for root in roots:
        assert root["parent"] is None and root["thread"] == "MainThread"
        names = [c["name"] for c in kids[root["id"]]]
        caller = (["save.graph", "save.slot_wait", "save.snapshot"]
                  if async_mode else ["save.graph"])
        assert names == caller + ["save.body"]
        body = kids[root["id"]][-1]
        thread = "chipmink-podding" if async_mode else "MainThread"
        assert body["thread"] == thread
        assert [c["name"] for c in kids[body["id"]]] == BODY
        dig = next(c for c in kids[body["id"]] if c["name"] == "save.digest")
        assert [c["name"] for c in kids[dig["id"]]] == ["save.digest.call"]
        com = kids[body["id"]][-1]
        assert [c["name"] for c in kids[com["id"]]] == COMMIT
        # every span below the body: its thread, its save
        stack = [body]
        while stack:
            r = stack.pop()
            assert r["thread"] == thread and r["time_id"] == root["time_id"]
            assert r["session"] is None and r["start_ns"] <= r["end_ns"]
            stack.extend(kids.get(r["id"], []))
        if not async_mode:
            assert root["start_ns"] <= body["start_ns"] \
                <= body["end_ns"] <= root["end_ns"]


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_each_stage_key_is_its_spans_duration(tracing, async_mode):
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 12, device="cpu",
                  async_mode=async_mode)
    saves(ck, make_state(), 3)
    records = trace.spans()
    for st in ck.save_stats:
        mine = {r["name"]: r for r in records
                if r["time_id"] == st["time_id"]}
        want = {k for n, k in KEYS.items() if n in mine}
        assert want == {k for k in st if k.startswith("t_")} - {
            "t_body_cpu", "t_delta_encode", *SUMMED.values()}
        for name, key in KEYS.items():
            if name in mine:
                assert st[key] == pytest.approx(dur(mine[name]) * 1e-9,
                                                rel=1e-9, abs=1e-9), key
        for name, key in SUMMED.items():
            ns = [dur(r) for r in records
                  if r["time_id"] == st["time_id"] and r["name"] == name]
            assert st[key] == pytest.approx(sum(ns) * 1e-9,
                                                   rel=1e-9, abs=1e-9), key
        body = mine["save.body"]
        assert st["t_body_cpu"] == pytest.approx(body["cpu_ns"] * 1e-9)
        assert 0 < st["t_body_cpu"]


def test_the_stages_keep_their_boundaries(tracing):
    """The stage timers nest as they did as timer pairs: each inside the
    body, one after another, the digest's call inside the digest."""
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 12, device="cpu")
    saves(ck, make_state(), 2)
    by_id, kids = trees(trace.spans())
    body = [r for r in trace.spans() if r["name"] == "save.body"][-1]
    stages = kids[body["id"]]
    for a, b in zip(stages, stages[1:]):
        assert a["end_ns"] <= b["start_ns"]
    assert body["start_ns"] <= stages[0]["start_ns"]
    assert stages[-1]["end_ns"] <= body["end_ns"]


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_the_stages_cover_the_body(tracing, async_mode):
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 12, device="cpu",
                  async_mode=async_mode)
    saves(ck, make_state(rows=2048), 5)
    by_id, kids = trees(trace.spans())
    bodies = [r for r in trace.spans() if r["name"] == "save.body"]
    assert len(bodies) == 5
    # the median save: a thread the scheduler parks between two stages
    # adds time no stage holds, and no work, to one save now and then;
    # work that escapes its stage does so in most saves
    assert median(covered(b, kids) for b in bodies) >= COVER


def test_a_session_save_is_one_tree_and_its_stall(tracing):
    svc = SessionService(MemoryStore(), pool_size=1, chunk_bytes=1 << 12,
                         device="cpu")
    svc.open_session("a")
    state = make_state(1, rows=2048)
    for k in range(5):
        if k:
            step(state, k)
        svc.save_session("a", {"cache": state})
    records = trace.spans()
    by_id, kids = trees(records)
    outer = [r for r in records if r["name"] == "session.save"]
    assert len(outer) == 5 == len(svc.save_stalls)
    for r, stall in zip(outer, svc.save_stalls):
        assert r["parent"] is None and r["session"] == "a"
        assert stall == pytest.approx(dur(r) * 1e-9, rel=1e-9, abs=1e-9)
        (save,) = kids[r["id"]]
        assert save["name"] == "save" and save["session"] == "a"
        body = kids[save["id"]][-1]
        com = kids[body["id"]][-1]
        assert [c["name"] for c in kids[com["id"]]] == [
            "save.commit.manifest", "save.commit.refcounts",
            "save.commit.refs"]
        assert all(x["session"] == "a" for x in kids[body["id"]])
    assert median(covered(r, kids) for r in outer) >= COVER
    bodies = [r for r in records if r["name"] == "save.body"]
    assert median(covered(b, kids) for b in bodies) >= COVER


def test_tracing_off_records_nothing():
    trace.enable()
    trace.disable()
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 12, device="cpu",
                  async_mode=True)
    saves(ck, make_state(), 2)
    assert trace.spans() == []
    st = ck.save_stats[-1]
    # the stage timers still run, and the body's CPU clock, the one span
    # that asks for it
    assert st["t_body"] > 0 and st["t_commit"] > 0
    assert 0 < st["t_body_cpu"]


def test_a_span_opened_before_tracing_starts_records_nothing():
    stats = {}
    sp = trace.span("outer", stats, "t_outer")
    with sp:
        trace.enable()
        try:
            with trace.span("inner"):
                pass
        finally:
            trace.disable()
    (inner,) = trace.spans()
    assert inner["name"] == "inner" and inner["parent"] is None
    assert stats["t_outer"] == sp.seconds > 0


def test_the_log_keeps_its_newest_records(monkeypatch):
    monkeypatch.setattr(trace, "LIMIT", 4)
    trace.enable()
    try:
        for i in range(10):
            with trace.span(f"s{i}"):
                pass
    finally:
        trace.disable()
    assert [r["name"] for r in trace.spans()] == ["s6", "s7", "s8", "s9"]


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_unread_keys_are_gone_from_stats_and_manifests(async_mode):
    store = MemoryStore()
    ck = Chipmink(store, chunk_bytes=1 << 12, device="cpu",
                  async_mode=async_mode)
    saves(ck, make_state(), 3)
    for st in ck.save_stats:
        assert not set(REMOVED) & set(st)
        kept = store.get_manifest(st["time_id"])["stats"]
        assert not set(REMOVED) & set(kept)
        assert kept["t_digest"] == st["t_digest"]


def test_the_clock_is_the_unix_epoch():
    import time
    a = time.time_ns()
    t = trace.clock_ns()
    b = time.time_ns()
    assert a - 1_000_000 <= t <= b + 1_000_000


def test_the_compiled_steps_are_spans(tracing):
    """``train.step`` and ``decode.step``: one span a call, on the
    caller's thread, outside any save."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.train.serve_step import compile_decode_step
    from repro_torch.train.train_step import compile_train_step

    def step_fn(state, batch):
        return {"w": state["w"] + batch["x"]}, {"loss": state["w"].sum()}

    graph = compile_train_step(step_fn, {"w": torch.zeros(4)},
                               {"x": torch.ones(4)}, device="cpu")
    state = graph.state
    for _ in range(3):
        state, _ = graph(state, {"x": torch.ones(4)})
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = model.init_model_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    dec = compile_decode_step(cfg, params,
                              model.api(cfg).init_cache(cfg, 1, 4,
                                                        device="cpu"),
                              device="cpu")
    dec(torch.zeros(1, 1, dtype=torch.int32))
    names = [r["name"] for r in trace.spans()]
    assert names == ["train.step"] * 3 + ["decode.step"]
    assert all(r["parent"] is None and r["thread"] == "MainThread"
               for r in trace.spans())
    assert torch.equal(state["w"], torch.full((4,), 3.0))
