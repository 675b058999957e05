"""Median device time of one compiled train step (`TrainGraph` call:
batch copy and graph replay), by CUDA events around every call in
the window."""
from chipbench.harness.readers import median_ms


def read(rec):
    return median_ms(rec, "step_ms")
