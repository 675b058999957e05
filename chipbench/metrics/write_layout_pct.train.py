"""Share of the pod blobs that the window's saves built in the
write stage and filled from the layout their assignment keeps (an
earlier save's static bytes around the chunk bytes) rather than packed
whole: 100 x sum of `n_pods_from_layout` / sum of
`n_pods_serialized`, the program's counters.  A program without the
counters reads nothing."""
from chipbench.harness.readers import share_pct


def read(rec):
    return share_pct(rec, "n_pods_from_layout", ["n_pods_serialized"])
