"""Host seconds of the static checker (`readonly_state_leaves`) on
Qwen1.5-0.5B's full-width train step: its first call in this process, as
`train()` pays it once per process, and a second call, each split into
its `make_fx` traces (the step's, then the functionalized graph's when
the first graph holds an op that may write; those ops are listed).

    PYTHONPATH=src python experiments/ascc_trace_time.py [--layers 24] \
        [--device meta] [--always-functionalize]

The state holds the real shapes on ``--device`` (``meta``: no memory;
``cuda``: the card's tensors, as the trainer traces them), the batch is
8 x 128 tokens, as `chip_smoke.py` phase 10 trains.  Start a fresh
process for each reading of a first call.  ``--always-functionalize``
takes the second trace even when no op may write, to price it.
"""
import argparse
import collections
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import ascc
from repro_torch.models.layers import unflatten
from repro_torch.models.model import api
from repro_torch.train import optimizer, train_step


def timed_make_fx(traces: list):
    """`make_fx` that appends (seconds, graph) of each trace to `traces`."""
    real = ascc.make_fx

    def make_fx(*args, **kw):
        trace = real(*args, **kw)

        def run(*xs):
            t = time.perf_counter()
            gm = trace(*xs)
            traces.append((time.perf_counter() - t, gm.graph))
            return gm
        return run
    return make_fx


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--device", default="meta")
    ap.add_argument("--always-functionalize", action="store_true")
    a = ap.parse_args()
    may_write = ascc._may_write
    if a.always_functionalize:
        ascc._may_write = lambda node: True
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), n_layers=a.layers)
    params = unflatten({p: torch.zeros(d.shape, device=a.device,
                                       dtype=d.dtype or torch.bfloat16)
                        for p, d in api(cfg).param_defs(cfg).items()})
    opt_cfg = optimizer.OptConfig(lr=1e-3)
    state = train_step.init_train_state(cfg, params, opt_cfg)
    tokens = torch.zeros((8, 128), dtype=torch.int32, device=a.device)
    batch = {"tokens": tokens, "labels": tokens}
    step = train_step.make_train_step(cfg, opt_cfg, remat=False)
    traces: list = []
    ascc.make_fx = timed_make_fx(traces)
    for run in ("first", "second"):
        traces.clear()
        t = time.perf_counter()
        ro = ascc.readonly_state_leaves(step, state, batch)
        total = time.perf_counter() - t
        writes = collections.Counter(
            str(n.target) for n in traces[0][1].nodes if may_write(n))
        print(f"{run} call: checker {total:.3f} s ({len(ro)} read-only "
              f"leaves, {a.layers} layers, {a.device}); traces "
              f"{[round(s, 3) for s, _ in traces]} s, the step's graph "
              f"{len(traces[0][1].nodes)} nodes, ops that may write "
              f"{dict(writes)}", flush=True)


if __name__ == "__main__":
    main()
