"""Share of the window's async save bodies that their thread spent off
the CPU: 100 x the sum of `t_body` - `t_body_cpu` over the sum of
`t_body` (span ``save.body``, whose thread CPU time the program records
in every save): waits for the interpreter lock, a lock, a blocking
fetch, the scheduler."""


def read(rec):
    stats = [st for st in rec.get("save_stats") or []
             if "t_body" in st and "t_body_cpu" in st]
    wall = sum(st["t_body"] for st in stats)
    if wall <= 0:
        return None
    return 100.0 * (wall - sum(st["t_body_cpu"] for st in stats)) / wall
