"""90th percentile of the host time of the `Chipmink.save()` calls the
loop made in the window (graph build and async snapshot: what the
training loop waits for)."""
from chipbench.harness.readers import percentile_ms


def read(rec):
    return percentile_ms(rec, "save_calls_s", 90.0, 1e3)
