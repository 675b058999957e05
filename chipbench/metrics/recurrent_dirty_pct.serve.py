"""Recurrent-state chunks found dirty over recurrent-state chunks
digested, summed over the window's session saves: the program's per-save
counters by leaf group (`dirty_by_group` / `chunks_by_group`), for the
groups of a recurrent layer's cache, its conv window and its state.  A
program without the counters, or a cache without recurrent layers, reads
nothing."""
from chipbench.harness.groups import group_share_pct

GROUPS = ("conv", "ssm", "lru")


def read(rec):
    return group_share_pct(rec, GROUPS)
