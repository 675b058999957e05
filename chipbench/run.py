"""Run one benchmark cell once on the card(s) of this machine.

    python3 chipbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: whether
the timed path's results were correct, the work attempted and failed,
the cell's end-to-end metrics (``--trace 0``) or per-layer metrics
(``--trace 1``), and the device; each number compared for ``correct``
beside its limit comes last there, and again as the last lines of
standard error.  Exits non-zero, printing no result, without enough CUDA
cards, when the program cannot be imported, when a run fails, or when
JAX or the JAX package was loaded.
"""
import os
import sys
import time

#: when the run's process started: a run that restarts itself under a
#: fixed hash seed keeps its first start (the monotonic clock is the
#: system's, so it reads the same in both processes)
T_START = float(os.environ.pop("CHIPBENCH_T_START", time.perf_counter()))

import argparse  # noqa: E402
import json  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    cache = ROOT / "build" / "chipbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    try:
        import torch
        from chipbench.harness import bench
        cell = bench.load_cell(a.workload, ROOT)
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if found < cell.chips:
            print(f"chipbench: {a.workload} needs {cell.chips} CUDA "
                  f"device(s); found {found}", file=sys.stderr)
            return 3
        out = bench.run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda",
                             T_START)
    except Exception:
        traceback.print_exc()
        return 1
    bad = bench.forbidden_modules()
    if bad:
        print(f"chipbench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def fixed_hash_seed() -> None:
    """Restart this process in place under PYTHONHASHSEED=0: the
    program's per-chunk host loops walk sets and dicts of string keys,
    whose layout, and with it the host time, would otherwise change
    from run to run."""
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.environ["PYTHONHASHSEED"] = "0"
        os.environ["CHIPBENCH_T_START"] = repr(T_START)
        os.execv(sys.executable, [sys.executable, *sys.argv])


if __name__ == "__main__":
    fixed_hash_seed()
    sys.exit(main())
