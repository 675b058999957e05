"""Run one cell once, traced, with the program's own span log on
(`repro_torch.core.trace`), and print what each thread of the program
was doing while the card sat idle.  The benchmark's own runs
(`run.py`) leave the log off; they never run this.

    python3 chipbench/idle_by_span.py --workload <name> --seed <n> \
        --seconds <s>

The log is on from the opening of the measured window to its close, and
is read when the run is over.  Prints one JSON object: whether the run
was correct, the cell's per-layer metrics as a traced run reads them,
and from the span log (`harness/attribute.py`):

- ``idle_unnamed_pct``: the share of the profiler's marked window's idle
  device time with no benchmark span and no program span open on any
  thread;
- ``caller_unspanned_pct``: the share of it in which the caller's thread
  was in no program span;
- ``session_save_unspanned_pct``: the self time of the containers of
  the window's ``session.save`` trees over their duration (the serving
  cells' `session_save_unspanned_pct.*` read from the span records);
- ``idle``: the idle time by what was open (``top``) and per thread;
- ``spans``: per span name of the window, its threads, count, median and
  90th percentile ms and median CPU share.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spanned_record(cell, seed: int, seconds: float, device: str) -> dict:
    """Run the cell once, traced, with the span log on over its window;
    its record, with ``program_spans`` and ``idle_attribution``
    (`attribute.record`)."""
    import torch
    from chipbench.harness import attribute, bench

    class SpannedRun(bench.Run):
        def window_open(self) -> float:
            t0 = super().window_open()
            self.log = attribute.program_trace()
            self.w0 = self.log.clock_ns()
            return t0

        def window_close(self) -> float:
            self.w1 = self.log.clock_ns()
            self.log.disable()
            return super().window_close()

        def tracer(self):
            self.profiled = super().tracer()
            return self.profiled

    run = SpannedRun(cell=cell, seed=seed, seconds=seconds, trace=True,
                     device=torch.device(device),
                     t_start=time.perf_counter())
    bench.driver(cell).run(run)
    attribute.record(run.record, run.log, run.profiled, run.w0, run.w1)
    return run.record


def summary(cell, rec: dict) -> dict:
    from chipbench.harness import attribute, bench
    a = rec.get("idle_attribution")
    metrics = {}
    for m in cell.per_layer:
        v = bench.reader(cell, m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = v
    return {"correct": rec["checks"].correct, "metrics": metrics,
            "idle_unnamed_pct": attribute.unnamed_pct(a),
            "caller_unspanned_pct": attribute.caller_unspanned_pct(a),
            "session_save_unspanned_pct": attribute.unspanned_pct(
                rec["program_spans"]),
            "idle": a,
            "spans": attribute.span_table(rec["program_spans"])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    cache = ROOT / "build" / "chipbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chipbench.harness import bench
    cell = bench.load_cell(a.workload, ROOT)
    rec = spanned_record(cell, a.seed, a.seconds, "cuda")
    print(json.dumps(summary(cell, rec)), flush=True)
    return 0


if __name__ == "__main__":
    # the same hash seed as the benchmark's runs (`run.fixed_hash_seed`)
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.environ["PYTHONHASHSEED"] = "0"
        os.execv(sys.executable, [sys.executable, *sys.argv])
    sys.exit(main())
