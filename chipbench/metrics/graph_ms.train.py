"""Median over the window's saves of the program's `t_graph` timer
(object graph build, `core/graph`, `core/graph_cache`)."""
from chipbench.harness.readers import stage_ms


def read(rec):
    return stage_ms(rec, ["t_graph"])
