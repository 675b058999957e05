"""The readers of the write stage's layout share (`write_layout_pct.*`),
on synthetic records and in a traced run of each cell on the CPU."""
import time

import pytest

from chipbench.harness import bench

from .test_chipbench_stats import metric
from .tiny import SERVE, TRAIN, tiny_cell

READERS = {TRAIN: "write_layout_pct.train", SERVE: "write_layout_pct.serve"}


@pytest.mark.parametrize("name", sorted(READERS.values()))
def test_the_share_pools_the_blobs_of_every_save(name):
    read = metric(name)
    rec = {"save_stats": [
        {"n_pods_serialized": 400, "n_pods_from_layout": 0},
        {"n_pods_serialized": 300, "n_pods_from_layout": 300},
        {"n_pods_serialized": 300, "n_pods_from_layout": 290},
        {"n_pods_serialized": 0, "n_pods_from_layout": 0}]}
    assert read(rec) == pytest.approx(100 * 590 / 1000)
    kept = {"save_stats": [{"n_pods_serialized": 50,
                            "n_pods_from_layout": 50}] * 3}
    assert read(kept) == 100.0


@pytest.mark.parametrize("name", sorted(READERS.values()))
def test_a_program_without_the_counters_reads_absent(name):
    """A program older than the counters records none: the metric is
    absent, not 0."""
    read = metric(name)
    older = {"save_stats": [{"t_write": 0.57, "pods_written": 31360,
                             "n_chunks": 35457}] * 4}
    assert read(older) is None
    assert read({"save_stats": []}) is None
    assert read({}) is None


@pytest.mark.parametrize("cell_name", [TRAIN, SERVE])
def test_a_traced_run_on_the_cpu_reads_the_share(tiny_root, monkeypatch,
                                                  cell_name):
    """Within the window every save follows one of the same structure:
    the pods it writes were laid out by an earlier save, but a pod that
    a session writes for the first time under its assignment."""
    monkeypatch.setattr(bench.Run, "tracer", lambda self: None)
    cell = tiny_cell(tiny_root, cell_name)
    out = bench.run_cell(cell, 2**31 + 30, 3.0, True, "cpu",
                         time.perf_counter())
    assert out["correct"]
    assert 50.0 < out["metrics"][READERS[cell_name]]["value"] <= 100.0
