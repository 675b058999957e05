"""Loss curves of the reference's and the port's train step, side by
side, on the CPU: Qwen1.5-0.5B at full width and a depth of your choice,
the trainer's optimizer (AdamW, lr 1e-3) and data stream, both packages
starting from the reference's parameters.

    PYTHONPATH=src python experiments/train_trend.py --layers 4 \
        --batch 8 --seq 128 --steps 8

The reference's step runs under `jax.jit`, the port's eagerly.  Peak
host RSS of the process is about 11.5 GB at 2 layers and 20.5 GB at 12
(the 151,936 x 1,024 embedding and its logits dominate); a step takes
seconds at 2 layers and about 40 s at 12.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models.model import init_model_params as ref_init_params
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro.train.data import TokenPipeline
from repro_torch.configs import get_config
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.train import optimizer, train_step


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    a = ap.parse_args()
    ref_cfg = dataclasses.replace(ref_get_config("qwen1.5-0.5b"),
                                  n_layers=a.layers)
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), n_layers=a.layers)
    ref_state = ref_ts.init_train_state(
        ref_cfg, ref_init_params(ref_cfg, jax.random.key(0)),
        ref_opt.OptConfig(lr=a.lr))
    state = train_state_from_numpy(jax.tree.map(np.asarray, ref_state), "cpu")
    ref_step = jax.jit(ref_ts.make_train_step(
        ref_cfg, ref_opt.OptConfig(lr=a.lr), remat=False))
    step = train_step.make_train_step(cfg, optimizer.OptConfig(lr=a.lr),
                                      remat=False)
    pipe = TokenPipeline(cfg.vocab, a.batch, a.seq)
    print("step  ref_loss  port_loss  ref_grad_norm  port_grad_norm")
    for i in range(a.steps):
        batch = pipe.next_batch()
        ref_state, rm = ref_step(ref_state, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
        state, pm = step(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        print(f"{i:4d}  {float(rm['nll']):.6f}  {float(pm['nll']):.6f}  "
              f"{float(rm['grad_norm']):.6f}  {float(pm['grad_norm']):.6f}",
              flush=True)


if __name__ == "__main__":
    main()
