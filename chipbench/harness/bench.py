"""Load a cell by name and run it once.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name `BENCHMARK.json`
gives it:

- ``chipbench/configs/<config>.json``   the configuration's sizes;
- ``chipbench/traffic/<traffic>.json``  the traffic's parameters and the
  driver that runs it (``"driver"``);
- ``chipbench/drivers/<driver>.py``     a window loop, ``run(ctx)``;
- ``chipbench/limits/<cell>.json``      the limit of each number that
  decides ``correct``;
- ``chipbench/metrics/<metric>.py``     one reader per per-layer metric,
  ``read(record)``, which returns None when it finds nothing to read.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

from .spans import Spans

#: the checkout's root (holds BENCHMARK.json and chipbench/)
ROOT = Path(__file__).resolve().parents[2]
#: top-level modules the measured process may not hold once the window
#: has closed: JAX and the JAX package this port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in reported)]
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(root / conf["file"]),
                traffic=_json(root / "chipbench" / "traffic"
                              / f"{w['traffic']}.json"),
                limits=_json(root / "chipbench" / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per, root=root)


def load_module(path: Path) -> ModuleType:
    """A file of the benchmark as a module, by its path (metric files
    carry dots in their names)."""
    name = "chipbench_" + "_".join(path.with_suffix("").parts[-2:]) \
        .replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell) -> ModuleType:
    return load_module(cell.root / "chipbench" / "drivers"
                       / f"{cell.traffic['driver']}.py")


def reader(cell: Cell, metric: str):
    return load_module(cell.root / "chipbench" / "metrics"
                       / f"{metric}.py").read


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell, the run's arguments, and where it
    records.  The driver calls `window_open` when its first timed step
    begins and `window_close` when the window has closed."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    spans: Spans = None
    record: Dict = dataclasses.field(default_factory=dict)
    t0: Optional[float] = None
    t1: Optional[float] = None

    def __post_init__(self) -> None:
        self.spans = Spans(self.trace)

    def window_open(self) -> float:
        # every window starts from a collected heap, whatever set-up left,
        # and the collector's full passes in it walk only what the window
        # made: set-up's objects (the modules, the program's graphs and
        # tables) are frozen out of them, as a long-running server does
        # once it is warm
        gc.collect()
        gc.freeze()
        self.t0 = time.perf_counter()
        self.record["setup_s"] = self.t0 - self.t_start
        return self.t0

    def window_close(self) -> float:
        self.t1 = time.perf_counter()
        gc.unfreeze()
        return self.t1

    def tracer(self):
        """The steady profiler window of a traced run (units and lengths
        from the traffic's ``"profile"``); None in an untraced one."""
        if not self.trace:
            return None
        from .trace import Tracer
        p = self.cell.traffic["profile"]
        return Tracer(p["start"], p["warmup"], p["active"])


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Dict:
    """Run the cell once; the result line's object."""
    import torch
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
              device=torch.device(device), t_start=t_start)
    driver(cell).run(run)
    rec = run.record
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = reader(cell, m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {}
        for m in cell.end_to_end:
            v = rec["setup_s"] if m["name"] == "setup_s" \
                else rec["e2e"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": rec.get("memory_peak_bytes", 0)}
    out = {"correct": rec["checks"].correct,
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": dev}
    tr = rec.get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = rec["checks"].items
    return out
