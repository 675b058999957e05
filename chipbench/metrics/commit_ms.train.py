"""Median over the window's saves of the program's `t_commit` timer
(span ``save.commit``: the manifest, the refcounts and the refs CAS, from
the end of the write to the end of the commit unit)."""
from chipbench.harness.readers import stage_ms


def read(rec):
    return stage_ms(rec, ["t_commit"])
