"""Version manager: the version-control layer over the content-addressed
store.

    CommitDAG      — persisted commit graph over manifests with branch
                     refs, tags, HEAD and lineage queries (commit_graph.py)
    fsck           — recovery scan: classify torn saves, roll refs back
                     to the newest complete commit, sweep debris
                     (fsck.py)

Delta-aware checkout, mark-and-sweep GC and the refcount index are not
ported yet (ROADMAP).  Imports run core→version strictly through lazy
imports inside Chipmink methods.
"""
from .commit_graph import DEFAULT_BRANCH, CommitDAG, PodDelta, RefsCASError
from .fsck import FsckReport, fsck

__all__ = ["CommitDAG", "DEFAULT_BRANCH", "FsckReport", "PodDelta",
           "RefsCASError", "fsck"]
