"""KV-cache chunks found dirty over KV-cache chunks digested, summed over
the window's session saves: the program's per-save counters by leaf
group (`dirty_by_group` / `chunks_by_group`) for the attention layers'
``k`` and ``v``.  A program without the counters reads nothing."""
from chipbench.harness.groups import group_share_pct

GROUPS = ("k", "v")


def read(rec):
    return group_share_pct(rec, GROUPS)
