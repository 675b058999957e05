"""90th percentile over the window's saves of the program's
`t_slot_wait` timer (span ``save.slot_wait``: how long `save()` waited
for a free slot of the async pipeline)."""
from chipbench.harness.stats import percentile


def read(rec):
    return percentile([st["t_slot_wait"] * 1e3
                       for st in rec.get("save_stats") or []
                       if "t_slot_wait" in st], 90.0)
