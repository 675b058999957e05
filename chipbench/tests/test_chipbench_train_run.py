"""A whole run of the training cell on the CPU at a tiny width: the
program's own loop pieces, its CPU kernels, the window, the checks."""
import math

from chipbench.harness import bench

from .tiny import TRAIN, run_tiny, tiny_cell


def test_a_tiny_training_run_is_correct_and_reports_its_metrics(tiny_root):
    cell = tiny_cell(tiny_root, TRAIN)
    out = run_tiny(cell, seconds=4.0)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(cell.limits)
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    assert list(out)[-1] == "checks"


def test_the_record_holds_what_the_readers_read(tiny_root):
    cell = tiny_cell(tiny_root, TRAIN)
    import time
    run = bench.Run(cell=cell, seed=5, seconds=4.0, trace=False,
                    device=__import__("torch").device("cpu"),
                    t_start=time.perf_counter())
    bench.driver(cell).run(run)
    rec = run.record
    assert rec["n_saves"] >= 1 and rec["store_growth_bytes"] > 0
    assert len(rec["save_stats"]) == rec["n_saves"]
    assert rec["flops_per_step"] > 0 and rec["digest_bound_s"] > 0
    mb = bench.reader(cell, "store_mb_per_save.train")(rec)
    assert math.isclose(mb, rec["store_growth_bytes"] / rec["n_saves"] / 1e6)
    assert 0 < bench.reader(cell, "dirty_chunk_pct.train")(rec) < 100
    # the window's rate is its steps' tokens over its own seconds
    t = cell.traffic
    assert math.isclose(rec["e2e"]["train_tokens_per_s"] * (run.t1 - run.t0),
                        rec["attempted"] * t["batch"] * t["seq_len"])
