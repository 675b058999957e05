"""Median over the window's session saves of the program's `t_digest`
timer (change detection: `core/change_detector`, `kernels/batch`,
`kernels/fingerprint`, the digest fetch)."""
from chipbench.harness.readers import stage_ms


def read(rec):
    return stage_ms(rec, ["t_digest"])
