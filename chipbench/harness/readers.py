"""What the per-layer metric files share: each of them reads one number
from a traced run's record, or None where the record holds nothing for
it to read."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..reference import peaks
from .stats import median, percentile


def stage_ms(rec: Dict, keys: Sequence[str]) -> Optional[float]:
    """Median over the window's saves of the program's stage timers
    `keys` (seconds, summed per save), in ms."""
    stats = rec.get("save_stats") or []
    vals = [sum(st[k] for k in keys) * 1e3 for st in stats
            if all(k in st for k in keys)]
    return median(vals)


def share_pct(rec: Dict, part: str, whole: Sequence[str]) -> Optional[float]:
    """100 x the sum of counter `part` over the window's saves, over the
    sum of the counters `whole`."""
    stats = rec.get("save_stats") or []
    den = sum(st.get(k, 0) for st in stats for k in whole)
    if not den:
        return None
    return 100.0 * sum(st.get(part, 0) for st in stats) / den


def median_ms(rec: Dict, key: str, scale: float = 1.0) -> Optional[float]:
    return median([v * scale for v in rec.get(key) or []])


def percentile_ms(rec: Dict, key: str, q: float,
                  scale: float = 1.0) -> Optional[float]:
    return percentile([v * scale for v in rec.get(key) or []], q)


def store_mb_per_save(rec: Dict) -> Optional[float]:
    if not rec.get("n_saves"):
        return None
    return rec["store_growth_bytes"] / rec["n_saves"] / 1e6


def idle_pct(rec: Dict) -> Optional[float]:
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kernel_roofline_pct(rec: Dict, names: Sequence[str]) -> Optional[float]:
    """100 x the least time of the digest passes the trace recorded
    (one launch of any of `names` a save) over their device time."""
    tr = rec.get("trace")
    if not tr or not rec.get("digest_bound_s"):
        return None
    launches = seconds = 0.0
    for op, v in tr["ops"].items():
        if any(n in op for n in names):
            launches += v["count"]
            seconds += v["s"]
    if not launches or seconds <= 0:
        return None
    return 100.0 * launches * rec["digest_bound_s"] / seconds


def mfu_pct(flops: float, seconds: float) -> Optional[float]:
    if not flops or seconds <= 0:
        return None
    return 100.0 * flops / seconds / peaks.BF16_FLOPS
