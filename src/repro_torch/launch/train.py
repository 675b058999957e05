"""End-to-end training driver with Chipmink incremental checkpointing.
The port of `repro.launch.train`.  Its batches hold tokens and labels,
as the reference's do, so it trains the decoder families (dense, moe,
ssm, hybrid); the vlm and encdec families need patch embeddings or
frames, which neither package's trainer supplies.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --reduced --steps 50 --save-every 10 --store /tmp/ck [--device cpu]

Runs real training on ``device`` (``"cuda"`` by default; it raises
without a card), saving through Chipmink every `save_every` steps (async
by default): the step's touch report (frozen masks, MoE expert counts)
drives the active-variable filter, the static checker (`core.ascc`)
proves frozen leaves read-only, and the data-pipeline cursor rides along
as host state.  Where the reference jits the step, the loop steps through
`compile_train_step` over the same eager step the checker traced: on a
card one CUDA graph per `train` call, captured before the first save and
replayed at every step, writing the state in place (a failed capture
raises; there is no eager path on the card).  As in the reference,
``--reduced`` is on and cannot be turned off from the command line;
`train(..., reduced=False)` runs the full-width configuration.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import torch

from ..configs import get_config
from ..core import Chipmink, FileStore, LGA, MemoryStore
from ..core.ascc import readonly_state_leaves
from ..models.model import init_model_params
from ..train.data import TokenPipeline
from ..train.optimizer import OptConfig
from ..train.train_step import (compile_train_step, init_train_state,
                                make_train_step,
                                touched_prefixes_from_metrics)


def snapshot_of(state: Dict, pipeline: TokenPipeline) -> Dict:
    """Chipmink namespace: device state + host pipeline cursor."""
    return {"params": state["params"], "opt": state["opt"],
            "step": int(state["step"]),
            "data": pipeline.cursor()}


def batch_on(batch: Dict, device: Any) -> Dict:
    """A pipeline batch (numpy int32) as tensors on `device`."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train(arch: str, *, steps: int = 50, save_every: int = 10,
          store_dir: Optional[str] = None, reduced: bool = True,
          global_batch: int = 8, seq_len: int = 128,
          frozen: tuple = (), async_save: bool = True,
          grad_compress: bool = False, log: bool = True,
          device: Any = "cuda") -> Dict:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train(device='cuda') needs a CUDA device and none "
                           "is available; pass device='cpu'")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    opt_cfg = OptConfig(lr=1e-3)
    params = init_model_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    state = init_train_state(cfg, params, opt_cfg, grad_compress=grad_compress)
    pipeline = TokenPipeline(cfg.vocab, global_batch, seq_len)
    step_fn = make_train_step(cfg, opt_cfg, frozen=frozen,
                              grad_compress=grad_compress, remat=False)

    store = FileStore(store_dir) if store_dir else MemoryStore()
    ck = Chipmink(store, LGA(), chunk_bytes=1 << 18, async_mode=async_save,
                  device=device)

    # ASCC: prove which state leaves the step provably returns unchanged
    example = batch_on(pipeline.next_batch(), device)
    pipeline.restore({**pipeline.cursor(), "step": 0})
    readonly = readonly_state_leaves(step_fn, state, example)
    readonly = {"params/" + p if not p.startswith(("params", "opt", "step"))
                else p for p in readonly}
    step = compile_train_step(step_fn, state, example, device=device)

    losses: List[float] = []
    t_start = time.time()
    metrics: Dict = {}
    for i in range(steps):
        batch = batch_on(pipeline.next_batch(), device)
        state, metrics = step(state, batch)
        losses.append(float(metrics["nll"]))
        if (i + 1) % save_every == 0 or i + 1 == steps:
            touched = touched_prefixes_from_metrics(cfg, metrics, frozen)
            tid = ck.save(snapshot_of(state, pipeline),
                          touched_prefixes=touched,
                          readonly_paths=readonly)
            if log:
                print(f"step {i+1:4d} loss={losses[-1]:.4f} "
                      f"saved TimeID={tid}", flush=True)
        elif log and (i + 1) % 10 == 0:
            print(f"step {i+1:4d} loss={losses[-1]:.4f}", flush=True)
    ck.wait()
    wall = time.time() - t_start
    if log:
        st = store.stats.as_dict()
        print(f"done: {steps} steps in {wall:.1f}s; "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
              f"store: {st['pods_written']} pods written, "
              f"{st['pods_deduped']} deduped, "
              f"{store.total_bytes()/1e6:.1f} MB total", flush=True)
    return {"losses": losses, "chipmink": ck, "state": state,
            "pipeline": pipeline, "store": store, "wall": wall,
            "readonly": readonly}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen1.5-0.5b")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--save-every", type=int, default=10)
    p.add_argument("--store", default=None)
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--frozen", nargs="*", default=[])
    p.add_argument("--sync-save", action="store_true")
    p.add_argument("--grad-compress", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    train(a.arch, steps=a.steps, save_every=a.save_every, store_dir=a.store,
          reduced=a.reduced, global_batch=a.batch, seq_len=a.seq,
          frozen=tuple(a.frozen), async_save=not a.sync_save,
          grad_compress=a.grad_compress, device=a.device)


if __name__ == "__main__":
    main()
