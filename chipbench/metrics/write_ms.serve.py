"""Median over the window's session saves of the program's `t_write`
timer (serialize and store the written pods, `core/store`)."""
from chipbench.harness.readers import stage_ms


def read(rec):
    return stage_ms(rec, ["t_write"])
