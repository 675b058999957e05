"""Chunks found dirty over chunks digested, summed over the window's
session saves (the program's `n_dirty_chunks` / `n_chunks`
counters)."""
from chipbench.harness.readers import share_pct


def read(rec):
    return share_pct(rec, "n_dirty_chunks", ["n_chunks"])
