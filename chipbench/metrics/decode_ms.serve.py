"""Median device time of one compiled decode step (`DecodeGraph` call:
token copy and graph replay), by CUDA events around every call in the
window."""
from chipbench.harness.readers import median_ms


def read(rec):
    return median_ms(rec, "decode_ms")
