"""Non-linear exploration (the paper's versioning story, §1/§3.1), on the
PyTorch port:

Pre-train a base model, then fork TWO fine-tune branches with the version
manager — `branch` / `checkout` instead of raw parent TimeIDs.  One
branch freezes everything but the top layer, one freezes the embeddings.
Content-addressed pods dedup the branches against the base and each
other; delta-aware checkout hops between branch tips reading only the
pods that differ; `log` shows lineage; `gc` reclaims a discarded branch.

    PYTHONPATH=src python examples_torch/branch_and_timetravel.py [--device cpu]

Training steps through `compile_train_step`, which writes the state in
place (on the card one CUDA graph per branch); so the second branch forks
from the state `checkout("main")` hands back, with a step compiled anew
over it.
"""
import argparse
import os
import sys
import zlib

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.core import Chipmink, LGA, MemoryStore
from repro_torch.core.ascc import readonly_state_leaves
from repro_torch.launch.train import batch_on, snapshot_of
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.models.model import init_model_params
from repro_torch.train.data import TokenPipeline
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (compile_train_step,
                                          init_train_state, make_train_step)


def run_branch(name, ck, cfg, state, frozen, device, steps=10):
    """Fork a branch at the current HEAD and fine-tune on it."""
    ck.branch(name)
    opt_cfg = OptConfig(lr=1e-3)
    pipe = TokenPipeline(cfg.vocab, 4, 64, seed=zlib.crc32(name.encode())
                         % 1000)
    step_fn = make_train_step(cfg, opt_cfg, frozen=frozen, remat=False)
    batch = batch_on(pipe.next_batch(), device)
    readonly = readonly_state_leaves(step_fn, state, batch)
    step = compile_train_step(step_fn, state, batch, device=device)
    before = ck.store.total_bytes()
    tid = None
    for i in range(steps):
        batch = batch_on(pipe.next_batch(), device)
        state, metrics = step(state, batch)
        if (i + 1) % 5 == 0:
            tid = ck.save(snapshot_of(state, pipe), readonly_paths=readonly)
    wrote = ck.store.total_bytes() - before
    print(f"branch {name:10s}: frozen={len(frozen)} prefixes, "
          f"loss={float(metrics['nll']):.3f}, wrote {wrote/1e6:.2f} MB "
          f"(base was {before/1e6:.2f} MB), tip TimeID={tid}")
    return tid, state


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    device = p.parse_args().device
    cfg = get_config("qwen1.5-0.5b").reduced()
    opt_cfg = OptConfig(lr=1e-3)
    ck = Chipmink(MemoryStore(), LGA(), chunk_bytes=1 << 16, device=device)

    # base pre-training on main
    params = init_model_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    state = init_train_state(cfg, params, opt_cfg)
    pipe = TokenPipeline(cfg.vocab, 4, 64)
    step_fn = make_train_step(cfg, opt_cfg, remat=False)
    batches = [batch_on(pipe.next_batch(), device) for _ in range(10)]
    step = compile_train_step(step_fn, state, batches[0], device=device)
    for batch in batches:
        state, _ = step(state, batch)
    base_tid = ck.save(snapshot_of(state, pipe))
    ck.tag("base", at=base_tid)
    print(f"base model saved: TimeID={base_tid} (tag 'base'), "
          f"{ck.store.total_bytes()/1e6:.2f} MB")

    frozen_a = tuple(f"params/layers/{i}" for i in range(cfg.n_layers - 1)
                     ) + ("params/embed",)
    tid_a, _ = run_branch("top-only", ck, cfg, state, frozen_a, device)
    # rewind before the next fork: the first branch trained `state` in
    # place, so the fork starts from the commit checkout hands back
    state = train_state_from_numpy(ck.checkout("main"), device)
    tid_b, _ = run_branch("no-embed", ck, cfg, state, ("params/embed",),
                          device)

    # lineage: both branches fork from the base commit
    print("log(no-embed):",
          [(e["time_id"], e["branch"] or e["tag"]) for e in ck.log()])
    print(f"merge_base(top-only, no-embed) = "
          f"{ck.versions.merge_base('top-only', 'no-embed')} == {base_tid}")

    # delta-aware time travel: hop to the sibling tip, reading only the
    # pods the two branches do not share
    d = ck.diff("no-embed", "top-only")
    r0 = ck.store.stats.read_bytes
    ck.checkout("top-only")
    cs = ck.last_checkout_stats
    print(f"checkout top-only: {cs.n_pods_fetched}/{cs.n_pods} pods from "
          f"store ({(ck.store.stats.read_bytes - r0)/1e6:.2f} MB read), "
          f"{cs.n_pods_live} served from memory; branches share "
          f"{d.n_shared} pods ({d.bytes_shared/1e6:.2f} MB)")

    # time travel to the tagged base, then gc a discarded branch
    base = ck.checkout("base")
    print(f"time-travel to tag 'base': step={base['step']}")
    ck.checkout("top-only")
    ck.versions.delete_branch("no-embed")
    g = ck.gc()
    st = ck.store.stats.as_dict()
    print(f"gc: swept {g.n_pods_deleted} pods / {g.n_commits_deleted} "
          f"commits, reclaimed {g.bytes_reclaimed/1e6:.2f} MB; store now "
          f"{ck.store.total_bytes()/1e6:.2f} MB; "
          f"{st['pods_deduped']} pod writes deduped across branches")


if __name__ == "__main__":
    main()
