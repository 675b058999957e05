"""Pods aliased to content already stored over pods aliased or
written, summed over the window's session saves (the program's
`pods_aliased` and `pods_written` counters)."""
from chipbench.harness.readers import share_pct


def read(rec):
    return share_pct(rec, "pods_aliased", ["pods_written", "pods_aliased"])
