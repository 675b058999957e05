"""The store's growth (`total_bytes()`) over the window, over the
session saves the window made, in MB (1e6 bytes)."""
from chipbench.harness.readers import store_mb_per_save


def read(rec):
    return store_mb_per_save(rec)
