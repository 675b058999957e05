"""Median over the window's saves of the program's `t_gather` timer
(`podding.fused_chunk_fetch`: dirty pods' bytes to the host)."""
from chipbench.harness.readers import stage_ms


def read(rec):
    return stage_ms(rec, ["t_gather"])
