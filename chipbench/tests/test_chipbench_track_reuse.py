"""The readers of the flip tracker's reuse share (`track_reuse_pct.*`),
on synthetic records and in a traced run of each cell on the CPU."""
import time

import pytest

from chipbench.harness import bench

from .test_chipbench_stats import metric
from .tiny import SERVE, TRAIN, tiny_cell

READERS = {TRAIN: "track_reuse_pct.train", SERVE: "track_reuse_pct.serve"}


@pytest.mark.parametrize("name", sorted(READERS.values()))
def test_reuse_pools_the_rows_of_every_save(name):
    read = metric(name)
    rec = {"save_stats": [
        {"n_track_rows": 1000, "n_track_rows_built": 1000},
        {"n_track_rows": 1000, "n_track_rows_built": 0},
        {"n_track_rows": 2000, "n_track_rows_built": 10}]}
    assert read(rec) == pytest.approx(100 * (1 - 1010 / 4000))
    unchanged = {"save_stats": [{"n_track_rows": 500,
                                 "n_track_rows_built": 0}] * 3}
    assert read(unchanged) == 100.0


@pytest.mark.parametrize("name", sorted(READERS.values()))
def test_a_program_without_the_counters_reads_absent(name):
    """A program older than the tracker's counters records none: the
    metric is absent, not 0."""
    read = metric(name)
    older = {"save_stats": [{"t_track": 0.16, "n_chunks": 16385,
                             "n_dirty_chunks": 800}] * 4}
    assert read(older) is None
    assert read({"save_stats": []}) is None
    assert read({}) is None


@pytest.mark.parametrize("cell_name", [TRAIN, SERVE])
def test_a_traced_run_on_the_cpu_reads_the_reuse(tiny_root, monkeypatch,
                                                  cell_name):
    """Within the window every save follows one of the same structure,
    so the tracker reuses every row it built in set-up."""
    monkeypatch.setattr(bench.Run, "tracer", lambda self: None)
    cell = tiny_cell(tiny_root, cell_name)
    out = bench.run_cell(cell, 2**31 + 26, 3.0, True, "cpu",
                         time.perf_counter())
    assert out["correct"]
    assert out["metrics"][READERS[cell_name]]["value"] == 100.0
