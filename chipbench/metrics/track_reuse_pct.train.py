"""Share of the flip tracker's chunk rows whose features 0–8 were kept
from an earlier save rather than built, over the window's saves: 100 x
(1 - sum of `n_track_rows_built` / sum of `n_track_rows`), the
program's counters.  A program without the counters reads nothing."""
from chipbench.harness.readers import share_pct


def read(rec):
    built = share_pct(rec, "n_track_rows_built", ["n_track_rows"])
    return None if built is None else 100.0 - built
