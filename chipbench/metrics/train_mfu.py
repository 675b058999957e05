"""The training step's share of the card's bf16 peak: the FLOPs the
steps of the window require (`reference.counts.train_step_flops`: the
backward pass only as far down as the lowest trained layer) over their
CUDA-event time."""
from chipbench.harness.readers import mfu_pct


def read(rec):
    ms = rec.get("step_ms") or []
    return mfu_pct(rec.get("flops_per_step", 0) * len(ms), sum(ms) / 1e3)
