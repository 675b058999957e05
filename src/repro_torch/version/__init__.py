"""Version manager: the version-control layer over the content-addressed
store (the paper's continuous, non-linear exploration story, §1/§3.1).

    CommitDAG      — persisted commit graph over manifests with branch
                     refs, tags, HEAD, lineage queries, and pod-granular
                     `diff(a, b)` (commit_graph.py)
    delta_checkout — restore a commit fetching only pods that differ from
                     the in-memory state, then prime GraphCache /
                     ChangeDetector / PodAssignment so the next save runs
                     the incremental path (checkout.py)
    mark_and_sweep — GC pods and manifests unreachable from any ref, with
                     dry-run reclaim estimates and a refs-CAS validation
                     between mark and sweep (gc.py)
    refcount_reclaim — O(delta) eviction of dead branch tips driven by
                     the persistent `RefcountIndex` in store meta;
                     bit-identical in what it frees to mark_and_sweep,
                     which stays on as the fsck-time oracle
                     (refcount.py)
    fsck           — recovery scan: classify torn saves, roll refs back
                     to the newest complete commit, sweep debris, and
                     rebuild the refcount index (fsck.py)

`Chipmink` exposes the user surface (`branch` / `checkout` / `log` /
`tag` / `diff` / `gc` / `evict_branch` / `fsck`); this package holds the
mechanism.  Imports run core→version strictly through lazy imports
inside Chipmink methods, so the package depends on core and never the
reverse at import time.
"""
from .checkout import CheckoutStats, delta_checkout
from .commit_graph import DEFAULT_BRANCH, CommitDAG, PodDelta, RefsCASError
from .fsck import FsckReport, fsck
from .gc import GCStats, mark_and_sweep
from .refcount import REFCOUNTS_META_KEY, RefcountIndex, refcount_reclaim

__all__ = [
    "CheckoutStats", "CommitDAG", "DEFAULT_BRANCH", "FsckReport", "GCStats",
    "PodDelta", "REFCOUNTS_META_KEY", "RefcountIndex", "RefsCASError",
    "delta_checkout", "fsck", "mark_and_sweep", "refcount_reclaim",
]
