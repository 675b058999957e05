"""The decode steps' share of the card's bf16 peak: the FLOPs the
window's decode steps require (`reference.counts.decode_step_flops`:
each token's top-k experts only) over their CUDA-event time."""
from chipbench.harness.readers import mfu_pct


def read(rec):
    ms = rec.get("decode_ms") or []
    return mfu_pct(rec.get("decode_flops", 0), sum(ms) / 1e3)
