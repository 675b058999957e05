"""Rates, percentiles and shares are taken over every sample of the
window; the store's bytes per save come from its growth over the
window."""
import statistics

import pytest

from chipbench.harness import stats
from chipbench.harness.bench import load_module

from .tiny import REPO


def metric(name):
    return load_module(REPO / "chipbench" / "metrics" / f"{name}.py").read


@pytest.mark.parametrize("q", [0, 5, 50, 90, 95, 100])
def test_percentile_interpolates_over_all_samples(q):
    xs = [float(v) for v in (7, 1, 3, 100, 2, 9, 4, 8, 5, 6)]
    ys = sorted(xs)
    pos = (len(ys) - 1) * q / 100
    lo = int(pos)
    want = ys[lo] + (ys[min(lo + 1, len(ys) - 1)] - ys[lo]) * (pos - lo)
    assert stats.percentile(xs, q) == pytest.approx(want)
    assert stats.percentile([], q) is None


def test_p95_sees_the_tail_that_chunk_medians_hide():
    # one token in eight waits out the snapshots: a median of 8-sample
    # chunks would read 70 ms; the 95th percentile over all reads the wait
    gaps = ([70.0] * 7 + [3000.0]) * 50
    assert stats.percentile(gaps, 95) == 3000.0
    assert stats.median([statistics.median(gaps[i:i + 8])
                         for i in range(0, len(gaps), 8)]) == 70.0


def test_stage_medians_and_shares_pool_every_save():
    rec = {"save_stats": [
        {"t_graph": 0.010, "t_digest": 1.0, "t_podding": 0.1,
         "t_decide": 0.05, "n_chunks": 100, "n_dirty_chunks": 1,
         "pods_written": 1, "pods_aliased": 99},
        {"t_graph": 0.030, "t_digest": 2.0, "t_podding": 0.2,
         "t_decide": 0.05, "n_chunks": 900, "n_dirty_chunks": 90,
         "pods_written": 10, "pods_aliased": 0},
        {"t_graph": 0.020, "t_digest": 3.0, "t_podding": 0.3,
         "t_decide": 0.05, "n_chunks": 1000, "n_dirty_chunks": 9,
         "pods_written": 0, "pods_aliased": 10}]}
    assert metric("graph_ms.train")(rec) == pytest.approx(20.0)
    assert metric("podding_ms.serve")(rec) == pytest.approx(250.0)
    # 100 of 2,000 chunks, not the mean of 1%, 10% and 0.9%
    assert metric("dirty_chunk_pct.train")(rec) == pytest.approx(5.0)
    assert metric("dedup_pct.serve")(rec) == pytest.approx(
        100.0 * 109 / 120)
    assert metric("write_ms.train")({"save_stats": []}) is None
    assert metric("dirty_chunk_pct.serve")({}) is None


def test_store_bytes_per_save_come_from_the_window_growth():
    # async bodies overlap: each body's own bytes_written counts its
    # neighbours' writes too; the metric reads the window's growth only
    rec = {"store_growth_bytes": 3_000_000, "n_saves": 3,
           "save_stats": [{"bytes_written": 2_500_000}] * 3}
    for name in ("store_mb_per_save.train", "store_mb_per_save.serve"):
        assert metric(name)(rec) == pytest.approx(1.0)
        assert metric(name)({"n_saves": 0}) is None


def test_step_metrics_take_every_step_of_the_window():
    rec = {"step_ms": [70.0, 80.0, 90.0, 1000.0], "flops_per_step": 1e12,
           "save_calls_s": [0.1] * 9 + [2.0],
           "decode_ms": [20.0, 22.0, 30.0], "decode_flops": 3e9,
           "save_stalls_s": [0.5, 0.7, 0.6]}
    assert metric("train_step_ms")(rec) == pytest.approx(85.0)
    assert metric("train_mfu")(rec) == pytest.approx(
        100 * 4e12 / 1.24 / 989e12)
    assert metric("save_call_ms.train")(rec) == pytest.approx(
        stats.percentile([x * 1e3 for x in rec["save_calls_s"]], 90))
    assert metric("decode_ms.serve")(rec) == pytest.approx(22.0)
    assert metric("decode_mfu.serve")(rec) == pytest.approx(
        100 * 3e9 / 0.072 / 989e12)
    assert metric("session_save_ms.serve")(rec) == pytest.approx(600.0)
    assert metric("train_mfu")({"step_ms": []}) is None


def test_device_readers_read_the_trace_or_nothing():
    tr = {"busy_s": 0.25, "window_s": 1.0,
          "ops": {"leaves_cmp_kernel": {"count": 4, "s": 0.008},
                  "nvjet_gemm": {"count": 100, "s": 0.2}}}
    rec = {"trace": tr, "digest_bound_s": 0.0015}
    assert metric("device_idle_pct.train")(rec) == pytest.approx(75.0)
    assert metric("digest_roofline.serve")(rec) == pytest.approx(75.0)
    assert metric("device_idle_pct.serve")({"trace": None}) is None
    # no digest kernel in the window: nothing to read, never 0
    rec["trace"] = dict(tr, ops={"nvjet_gemm": {"count": 1, "s": 0.1}})
    assert metric("digest_roofline.train")(rec) is None
