"""The reader of the refcount index's reuse share
(`refcount_reuse_pct.serve`), on synthetic records and in a traced run
of the serving cell on the CPU."""
import time

import pytest

from chipbench.harness import bench

from .test_chipbench_stats import metric
from .tiny import SERVE, tiny_cell

NAME = "refcount_reuse_pct.serve"


def test_reuse_pools_the_entries_of_every_save():
    read = metric(NAME)
    rec = {"save_stats": [
        {"n_refcount_coded": 2000, "n_refcount_whole": 2000},
        {"n_refcount_coded": 50, "n_refcount_whole": 4000},
        {"n_refcount_coded": 50, "n_refcount_whole": 6000}]}
    assert read(rec) == pytest.approx(100 * (1 - 2100 / 12000))
    whole = {"save_stats": [{"n_refcount_coded": 700,
                             "n_refcount_whole": 700}] * 3}
    assert read(whole) == 0.0


def test_a_program_without_the_counters_reads_absent():
    """A program older than the counters, or one with no refcount
    index, records none: the metric is absent, not 0."""
    read = metric(NAME)
    older = {"save_stats": [{"t_commit_refcounts": 1.7,
                             "n_chunks": 35457}] * 4}
    assert read(older) is None
    assert read({"save_stats": []}) is None
    assert read({}) is None


def test_a_traced_run_on_the_cpu_reads_the_reuse(tiny_root, monkeypatch):
    """In the window every commit lands on the blob the pool last wrote,
    so it codes its own pods and the small maps, not the index."""
    monkeypatch.setattr(bench.Run, "tracer", lambda self: None)
    cell = tiny_cell(tiny_root, SERVE)
    out = bench.run_cell(cell, 2**31 + 28, 3.0, True, "cpu",
                         time.perf_counter())
    assert out["correct"]
    assert 50.0 < out["metrics"][NAME]["value"] < 100.0
