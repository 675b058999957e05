"""Median over the window's session saves of the program's
`t_podding` + `t_decide` timers (`core/lga`, `core/podding`, pod
digests and thesaurus lookups)."""
from chipbench.harness.readers import stage_ms


def read(rec):
    return stage_ms(rec, ["t_podding", "t_decide"])
