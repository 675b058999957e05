"""Median over the window's saves of the program's `t_digest_call` timer
(span ``save.digest.call``: the digest kernels' call, launch to fetched
result; the rest of `t_digest` is the detector's host walk)."""
from chipbench.harness.readers import stage_ms


def read(rec):
    return stage_ms(rec, ["t_digest_call"])
