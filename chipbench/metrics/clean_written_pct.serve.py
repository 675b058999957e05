"""Clean bytes dragged into written pods: of the chunk payload bytes
the window's session saves stored in pods, the share whose chunk's
digest had not changed (the program's `clean_written_bytes` over
`written_chunk_bytes`).  Low where podding keeps the chunks that change
apart from those that do not.  A program without the counters reads
nothing."""
from chipbench.harness.readers import share_pct


def read(rec):
    return share_pct(rec, "clean_written_bytes", ["written_chunk_bytes"])
