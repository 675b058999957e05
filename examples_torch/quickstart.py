"""Quickstart: train a small LM with Chipmink incremental checkpointing,
on the PyTorch port.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Trains qwen1.5-0.5b (reduced config) for 40 steps on the card (or the CPU
with ``--device cpu``), saving through Chipmink every 10 steps
(asynchronously), then time-travels back to the first checkpoint and
verifies bit-exact restore.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.launch.train import train


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    out = train("qwen1.5-0.5b", steps=40, save_every=10, global_batch=4,
                seq_len=64, reduced=True, device=a.device)
    ck = out["chipmink"]

    # time-travel: load the first checkpoint (step 10)
    first = ck.store.list_time_ids()[0]
    old = ck.load(names={"params", "step"}, time_id=first)
    print(f"\ntime-travel: TimeID={first} holds step={old['step']}")

    # the last checkpoint matches live state bit-for-bit
    live = out["state"]["params"]["embed"]
    latest = ck.load(names={"params"})["params"]["embed"]
    assert torch.equal(live.cpu(), latest.cpu())
    print("round-trip equivalence (Thm 7.1): latest checkpoint == live state")

    st = ck.store.stats.as_dict()
    print(f"store: {st['pods_written']} pods written, "
          f"{st['pods_deduped']} deduped on disk, "
          f"{ck.store.total_bytes()/1e6:.1f} MB for "
          f"{len(ck.store.list_time_ids())} checkpoints")


if __name__ == "__main__":
    main()
