"""Median of `SessionService.save_stalls` in the window: the host time
of each `save_session` call, the stall the serving loop waits out."""
from chipbench.harness.readers import median_ms


def read(rec):
    return median_ms(rec, "save_stalls_s", 1e3)
