"""Readers of the program's per-save counters by leaf group: a save's
``chunks_by_group`` and ``dirty_by_group`` count the chunks, and the
dirty ones, of the leaves whose path ends in each group name ("k", "v",
"conv", "ssm", ...)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence


def group_share_pct(rec: Dict, groups: Sequence[str]) -> Optional[float]:
    """100 x the dirty chunks of `groups` over their chunks, summed over
    the window's saves; None where no save counted a chunk of them."""
    stats = rec.get("save_stats") or []
    den = sum(st.get("chunks_by_group", {}).get(g, 0)
              for st in stats for g in groups)
    if not den:
        return None
    return 100.0 * sum(st.get("dirty_by_group", {}).get(g, 0)
                       for st in stats for g in groups) / den
