"""The store's growth (`total_bytes()`) from the window's start to the
drain after it, over the saves the window made, in MB (1e6 bytes).
Overlapping async bodies cannot inflate it, as they inflate a body's
own `bytes_written`."""
from chipbench.harness.readers import store_mb_per_save


def read(rec):
    return store_mb_per_save(rec)
