"""Share of the window's session saves that no stage of the program
names: 100 x the summed stall of the window's session saves (span
``session.save``, `rec["save_stalls_s"]`) less the stage timers that lie
inside it, over that summed stall.

The stages inside a stall are the leaves of the span tree under
``session.save``; the spans that only hold other spans (``save``,
``save.body``, ``save.commit``) add nothing of their own, so what the
leaves leave uncovered is the self time of those containers.  The
leaves are the caller's ``save.graph``, ``save.slot_wait`` and
``save.snapshot``, and, for a sync save (the body runs inline, inside
the stall; an async save's stats hold ``t_slot_wait``), the body's
stages and the commit's three steps.  A stage's own time
(``save.digest``'s host walk, ``save.write``'s serialization) is named
work."""

#: stage timers the caller's thread runs inside every save
CALLER = ("t_graph", "t_slot_wait", "t_snapshot")
#: stage timers of the save body, inside the stall of a sync save
BODY = ("t_avf", "t_digest", "t_track", "t_podding", "t_decide", "t_intent",
        "t_gather", "t_write", "t_commit_manifest", "t_commit_refcounts",
        "t_commit_refs")


def read(rec):
    stats = rec.get("save_stats") or []
    total = sum(rec.get("save_stalls_s") or [])
    # a program older than the commit's timers has nothing to read
    if total <= 0 or not stats \
            or not all("t_commit_refs" in st for st in stats):
        return None
    named = sum(st.get(k, 0.0) for st in stats
                for k in (CALLER if "t_slot_wait" in st else CALLER + BODY))
    return 100.0 * (total - named) / total
