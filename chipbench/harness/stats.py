"""Statistics the benchmark takes over all the samples of a window."""
from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0..100) of every sample, by linear
    interpolation between closest ranks; None without samples."""
    if not xs:
        return None
    ys = sorted(xs)
    pos = (len(ys) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(ys) - 1)
    return ys[lo] + (ys[hi] - ys[lo]) * (pos - lo)


def median(xs: Sequence[float]) -> Optional[float]:
    return percentile(xs, 50.0)
