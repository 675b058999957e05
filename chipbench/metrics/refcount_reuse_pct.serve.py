"""Share of the refcount index's entries that the window's session
saves kept from the blob they last wrote rather than decoded or packed
one by one: 100 x (1 - sum of `n_refcount_coded` / sum of
`n_refcount_whole`), the program's counters, where the whole counts a
decode and an encode of every entry of each blob written.  A program
without the counters reads nothing."""
from chipbench.harness.readers import share_pct


def read(rec):
    coded = share_pct(rec, "n_refcount_coded", ["n_refcount_whole"])
    return None if coded is None else 100.0 - coded
