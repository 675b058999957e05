"""Fault tolerance + elasticity, on the PyTorch port: inject failures
mid-training, restart from the latest Chipmink TimeID, and re-shard the
checkpoint onto a different mesh (elastic restore).

    PYTHONPATH=src python examples_torch/elastic_restart.py [--device cpu]

Training steps through `compile_train_step` (on the card one CUDA graph,
replayed at every step and writing the state in place); a restart hands
back new tensors, so the step is compiled anew over them.  The restore
lands on `make_local_mesh()`, a mesh over a single-rank process group
this script starts (NCCL on the card, gloo on the CPU).
"""
import argparse
import os
import socket
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import Chipmink, LGA, MemoryStore
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import batch_on, snapshot_of
from repro_torch.models.model import init_model_params, model_logical_axes
from repro_torch.runtime.fault_tolerance import (StragglerMonitor,
                                                 TrainingSupervisor,
                                                 elastic_restore)
from repro_torch.train.data import TokenPipeline
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (compile_train_step,
                                          init_train_state, make_train_step)
from repro_torch.train.tree import tree_leaves


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    device = p.parse_args().device
    cfg = get_config("qwen1.5-0.5b").reduced()
    opt_cfg = OptConfig(lr=1e-3)
    params = init_model_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    state = init_train_state(cfg, params, opt_cfg)
    pipe = TokenPipeline(cfg.vocab, 4, 64)
    step_fn = make_train_step(cfg, opt_cfg, remat=False)
    graph = None

    def do_step(st, i):
        nonlocal graph
        batch = batch_on(pipe.next_batch(), device)
        if graph is None or st is not graph.state:   # a restart's tensors
            graph = compile_train_step(step_fn, st, batch, device=device)
        new, _ = graph(st, batch)
        return new

    def restore(loaded):
        pipe.restore(loaded["data"])
        return {"params": loaded["params"], "opt": loaded["opt"],
                "step": torch.as_tensor(loaded["step"], dtype=torch.int32,
                                        device=device)}

    ck = Chipmink(MemoryStore(), LGA(), chunk_bytes=1 << 16, device=device)
    sup = TrainingSupervisor(ck, save_every=5)
    final, stats = sup.run(state, 25, do_step,
                           make_snapshot=lambda st: snapshot_of(st, pipe),
                           restore=restore, fail_at={8, 17})
    print(f"survived {stats['failures']} injected failures; "
          f"resumed from steps {stats['resumed_from']}; "
          f"final step={int(final['step'])}")

    # elastic restore onto the local mesh (any device count)
    loaded = ck.load(names={"params"})
    dist.init_process_group(
        "nccl" if torch.device(device).type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_local_mesh(device_type=torch.device(device).type)
        restored = elastic_restore(loaded["params"], mesh,
                                   model_logical_axes(cfg))
        n = sum(x.numel() for x in tree_leaves(restored))
        print(f"elastic restore onto mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}: {n:,} params")
    finally:
        dist.destroy_process_group()

    # straggler monitoring (simulated telemetry)
    mon = StragglerMonitor()
    rng = np.random.default_rng(0)
    for _ in range(12):
        for host in range(8):
            mon.record(host, 1.0 + 0.02 * rng.standard_normal()
                       + (1.2 if host == 5 else 0.0))
    rep = mon.report()
    print(f"straggler report: hosts {rep.stragglers} flagged "
          f"(median step {rep.global_median:.2f}s) — exclude & re-mesh")


if __name__ == "__main__":
    main()
