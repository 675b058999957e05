"""Chipmink: the object store (paper §3.1 user API + full save/load flow),
over torch state on a CUDA device.

    save(state) -> TimeID
    load(names, time_id) -> {name: value}

A save runs the paper's pipeline: build the ObjectGraph → active-variable
filter → change detection (device fingerprints) → podding (LGA) → pod
digests → thesaurus lookup (synonyms) → write dirty pods + manifest.
A load reverses it: manifest → resolve pods (synonyms are content-addressed)
→ unpod only what the requested names reach (partial loading).

Manifests, pods and stores are byte-identical to the reference package's
(`repro.core.checkpoint`) for the same state: a store written by either
package loads in the other.

Device.  ``Chipmink(..., device="cuda")`` is the default; without a CUDA
device the constructor raises.  A `torch.Tensor` leaf takes the device
path (batched packer, fingerprint kernel, device-resident digest table,
speculative gather, one counted fetch) and must lie on the instance's
device; an `np.ndarray` leaf takes the host twin.  With ``device="cpu"``
the device path runs the kernels' plain PyTorch versions.  `load`
returns tensors on the instance's device.

Incremental save pipeline (contract)
------------------------------------
With ``incremental=True`` (default) the host-side half of a save scales
with the *delta*, mirroring the device half's batched digest engine:

  * **Stable node ids** — `GraphCache` re-walks only changed subtrees and
    splices reused nodes; a key whose node survives keeps its id, so the
    previous `PodAssignment` (keyed by node id) stays addressable.
  * **Memo-local preservation** — when the build reports zero structural
    changes, the previous assignment (pods, locals, pages, edges) is
    reused verbatim: every untouched pod keeps its memo locals bit-exact,
    and only pods containing dirty chunks or changed scalars re-hash
    their structural digest.  Any structural change falls back to the
    full LGA walk, which — thanks to per-key decision memoization (§7.3)
    — is itself the parity oracle: from-scratch and incremental saves
    produce bit-identical pod bytes and manifests (modulo the timing
    stats block).

Single-sync save (``fused=True``, default)
------------------------------------------
The device half of a save is one round-trip: the fused digest kernels
compare against the device-resident previous table and the packed word
rows of *speculated* chunks (flip-EMA above ``spec_threshold``, expanded
to pod granularity plus the pods of changed scalars) ride along in the
same fetch as the digests and dirty flags.  The gather phase then
serializes written pods from those prefetched bytes; only
mispredicted-dirty chunks pay one corrective batched fetch
(``n_corrective_syncs``), so a warm sparse save costs exactly one
blocking device sync and any save at most two.  ``fused=False``
restores the two-sync path (digest fetch + payload gather) and
``batched=False`` the per-leaf path; manifests are bit-identical on
every rung.

Ablation switches (`enable_cd`, `enable_avf`) reproduce the paper's
§8.8/§8.9 baselines; `incremental=False` restores the from-scratch host
path.

Versioning: every save is a *commit* whose manifest records its parent
(HEAD by default); a commit DAG with branch refs / tags / HEAD persists
in the store (``branch``, ``tag``, ``log``).

Durability: every save is a pods → manifest → refs transaction (refs via
`BaseStore.compare_and_put_meta`); ``fsck_on_open`` (default True) runs
the recovery scan before the first save of a reopened store, and
transient `OSError`s in the write phase retry under ``retry_policy``.

Not ported yet (each raises `NotImplementedError` naming its ROADMAP
item): ``async_mode=True`` (torch tensors mutate in place, so an
overlapped save needs a device-side snapshot first), ``multi_writer=True``,
``delta_chains=True``, ``refcounts=True``, and ``checkout``, ``gc``,
``evict_branch`` and ``diff``.  The constructor keeps the reference's
defaults; its options that only configure those modes (lease timing,
delta policy, copy-on-submit, shared TimeIDs, CAS retry budgets) come
with them.  ``batched=False`` selects the per-leaf digest rung.
"""
from __future__ import annotations

import hashlib
import time as _time
from typing import Any, Dict, Iterable, List, Optional, Set

import torch

from ..kernels.ops import resolve_device
from .active_filter import ActiveVariableFilter
from .async_saver import AsyncSaver
from .change_detector import ChangeDetector, pack_digest_table
from .faults import RetryPolicy, call_with_retries
from .graph import CHUNK, ObjectGraph, build_graph
from .graph_cache import GraphCache, IncrementalBuildInfo
from .lga import LGA, PoddingPolicy
from .podding import (PodAssignment, Unpodder, batched_chunk_fetch,
                      fused_chunk_fetch, open_manifest, pod_graph,
                      pod_structural_digest, serialize_pod)
from .store import BaseStore, MemoryStore
from .thesaurus import PodThesaurus
from .volatility import FlipTracker

TimeID = int


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch package yet (ROADMAP queue 1, "
        f"{item})")


class Chipmink:
    def __init__(
        self,
        store: Optional[BaseStore] = None,
        policy: Optional[PoddingPolicy] = None,
        *,
        chunk_bytes: int = 1 << 22,
        thesaurus_capacity: int = 1 << 30,
        memo_page_size: int = 1024,
        enable_cd: bool = True,
        enable_avf: bool = True,
        async_mode: bool = False,
        incremental: bool = True,
        fused: bool = True,
        batched: bool = True,
        spec_threshold: float = 0.25,
        track_flips: bool = True,
        seed: int = 0,
        retry_policy: Optional[RetryPolicy] = None,
        fsck_on_open: Any = True,
        multi_writer: bool = False,
        delta_chains: bool = False,
        refcounts: bool = False,
        device: Any = "cuda",
    ) -> None:
        if async_mode:
            raise _not_ported("async_mode=True", "async_mode item")
        if multi_writer:
            raise _not_ported("multi_writer=True", "multi_writer item")
        if delta_chains:
            raise _not_ported("delta_chains=True", "delta_chains item")
        if refcounts:
            raise _not_ported("refcounts=True", "version/refcount.py item")
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError(
                "Chipmink(device='cuda') needs a CUDA device and none is "
                "available; pass device='cpu' to run the kernels' plain "
                "versions on the CPU")
        self.device = resolve_device(device)
        self.store = store if store is not None else MemoryStore()
        self.policy = policy if policy is not None else LGA()
        self.chunk_bytes = chunk_bytes
        self.memo_page_size = memo_page_size
        self.enable_cd = enable_cd
        self.enable_avf = enable_avf
        self.incremental = incremental
        self.detector = ChangeDetector(chunk_bytes=chunk_bytes, seed=seed,
                                       fused=fused, batched=batched,
                                       device=self.device)
        self.fused = self.detector.fused
        self.spec_threshold = spec_threshold
        self.thesaurus = PodThesaurus(capacity_bytes=thesaurus_capacity)
        self.tracker = FlipTracker() if track_flips else None
        self.avf = ActiveVariableFilter()
        self.saver = AsyncSaver()
        self._graph_cache = (GraphCache(chunk_bytes=chunk_bytes)
                             if incremental else None)
        self._prev_pods: Optional[PodAssignment] = None
        self._prev_graph: Optional[ObjectGraph] = None
        self._pod_digests: Dict[int, bytes] = {}   # prev save's pod digests
        self.retry_policy = (retry_policy if retry_policy is not None
                             else RetryPolicy())
        # Recovery scan before anything reads the store: a previous
        # process may have died mid-transaction.  True = quick (existence
        # + non-empty of every referenced pod); "deep" additionally
        # validates every pod's bytes.
        self.last_fsck = None
        if fsck_on_open:
            from ..version import fsck as _fsck
            self.last_fsck = _fsck(self.store,
                                   deep=(fsck_on_open == "deep"))
        # Resume TimeIDs after the store's newest manifest: a reopened
        # store must append commits, never overwrite them.
        existing = self.store.list_time_ids()
        self._next_time = (existing[-1] + 1) if existing else 1
        # runtime import: version depends on core, never the reverse at
        # module import time.
        from ..version import CommitDAG
        self.versions = CommitDAG(self.store)
        #: last saved tid; resumes from the persisted HEAD so a reopened
        #: instance chains its first commit to the old tip.
        self._head: Optional[TimeID] = self.versions.head_commit()
        self.save_stats: List[Dict[str, Any]] = []

    def close(self) -> List[BaseException]:
        """Shut down: drain the save pipeline, returning (not raising)
        any pending save errors.  Idempotent."""
        return self.saver.drain()

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def save(
        self,
        state: Any,
        *,
        accessed_vars: Optional[Iterable[str]] = None,
        touched_prefixes: Optional[Iterable[str]] = None,
        readonly_paths: Optional[Set[str]] = None,
        parent: Optional[TimeID] = None,
        branch: Optional[str] = None,
    ) -> TimeID:
        time_id = self._next_time
        self._next_time += 1
        if parent is None:
            if branch is not None:
                # commit onto a named ref: chain to ITS tip (None for a
                # branch this commit will create), never to local HEAD.
                parent = self.versions.branches.get(branch)
            else:
                parent = self._head      # commit chains to HEAD by default

        t0 = _time.perf_counter()
        if self._graph_cache is not None:
            graph, ginfo = self._graph_cache.build(state)
        else:
            graph = build_graph(state, chunk_bytes=self.chunk_bytes)
            ginfo = None
        t_graph = _time.perf_counter() - t0
        self._save_body(time_id, graph, ginfo, accessed_vars,
                        touched_prefixes, readonly_paths, parent, t_graph,
                        branch)
        self._head = time_id
        return time_id

    def wait(self) -> None:
        self.saver.wait()

    def _save_body(self, time_id, graph, ginfo, accessed_vars,
                   touched_prefixes, readonly_paths, parent, t_graph,
                   branch=None) -> None:
        try:
            self._save_body_inner(time_id, graph, ginfo, accessed_vars,
                                  touched_prefixes, readonly_paths, parent,
                                  t_graph, branch)
        except BaseException:
            # A half-applied save poisons the reuse chain: the graph cache
            # has already advanced, so the next save must re-pod and
            # re-hash from its own graph rather than trust artifacts of a
            # save that never finished.  Lineage must not name the failed
            # TimeID (it has no manifest) as a parent: fall back to the
            # last commit that actually landed.
            self._prev_pods = None
            self._prev_graph = None
            self._pod_digests = {}
            self._head = (self.versions.branches.get(branch)
                          if branch is not None
                          else self.versions.head_commit())
            raise

    def _speculate(self, graph: ObjectGraph,
                   ginfo: Optional[IncrementalBuildInfo]) -> Optional[Set[str]]:
        """Speculative dirty set for the fused single-sync save.

        Seeds: chunk keys whose flip EMA exceeds ``spec_threshold``
        (`FlipTracker.predicted`) plus keys of scalars the incremental
        build saw change (their pods re-serialize this save even though
        no chunk flipped — the step counter is the canonical case).

        The seed set is then expanded to **pod granularity** against the
        previous assignment: `serialize_pod` needs every chunk of a
        written pod, so speculating a chunk without its pod siblings
        would still pay the corrective gather.  Expansion requires the
        previous assignment to still describe this graph — same
        condition as assignment reuse (no structural change); otherwise
        speculation is skipped (a from-scratch save is all-dirty anyway
        and pays its one corrective gather).
        """
        if not self.fused or self.tracker is None:
            return None
        asg = self._prev_pods
        if (asg is None or ginfo is None or ginfo.from_scratch
                or ginfo.structural_change):
            return None
        seeds = self.tracker.predicted(self.spec_threshold)
        seeds.update(ginfo.scalar_changed_keys)
        pods: Set[int] = set()
        for key in seeds:
            nid = graph.by_key.get(key)
            if nid is not None and nid in asg.node_pod:
                pods.add(asg.node_pod[nid])
        out: Set[str] = set()
        for pid in pods:
            for nid in asg.pods[pid].node_ids:
                node = graph.node(nid)
                if node.kind == CHUNK:
                    out.add(node.key)
        return out or None

    def _save_body_inner(self, time_id, graph, ginfo, accessed_vars,
                         touched_prefixes, readonly_paths, parent,
                         t_graph, branch=None) -> None:
        stats: Dict[str, Any] = {"time_id": time_id, "t_graph": t_graph}
        if ginfo is not None:
            stats["t_graph_inc"] = t_graph
            stats["n_nodes_reused"] = ginfo.n_nodes_reused
            stats["n_nodes_rebuilt"] = ginfo.n_nodes_rebuilt
        t0 = _time.perf_counter()
        if self.enable_avf:
            active = self.avf.active_leaves(
                graph,
                readonly_paths=readonly_paths,
                touched_prefixes=touched_prefixes,
                prior_pods=self._prev_pods if accessed_vars is not None else None,
                prior_graph=self._prev_graph,
                accessed_vars=accessed_vars,
            )
        else:
            active = {n.key for n in graph.leaf_nodes()}
        stats["n_leaves"] = len(list(graph.leaf_nodes()))
        stats["n_active_leaves"] = len(active)
        stats["t_avf"] = _time.perf_counter() - t0

        t0 = _time.perf_counter()
        spec = self._speculate(graph, ginfo)
        report = self.detector.detect(graph, active, speculate=spec)
        stats["n_chunks"] = len(report.digests)
        stats["n_dirty_chunks"] = len(report.dirty)
        stats["t_digest"] = _time.perf_counter() - t0
        stats["n_digest_syncs"] = report.n_syncs
        stats["n_spec_predicted"] = len(spec) if spec else 0
        stats["n_spec_hits"] = report.n_spec_hits
        stats["n_spec_misses"] = report.n_spec_misses
        stats["n_fused_rows"] = report.fused_rows

        if self.tracker is not None:
            active_chunks = [n.key for n in graph.chunk_nodes()
                             if "/".join(n.path) in active]
            self.tracker.observe(graph, report.dirty, active_chunks)

        # podding: reuse the previous assignment verbatim when the graph
        # structure is unchanged (memo locals preserved, §7.3 stability);
        # otherwise rerun the full LGA walk — the parity oracle — with the
        # rebuilt-key set so feature preparation stays incremental.
        t0 = _time.perf_counter()
        pods_reused = (self.incremental and ginfo is not None
                       and not ginfo.from_scratch
                       and not ginfo.structural_change
                       and self._prev_pods is not None)
        if pods_reused:
            asg = self._prev_pods
            stats["n_pods_reused"] = len(asg.pods)
        else:
            asg = pod_graph(graph, self.policy,
                            flip_ema=self.tracker.ema if self.tracker else None,
                            memo_page_size=self.memo_page_size,
                            changed_keys=(ginfo.rebuilt_keys
                                          if ginfo is not None else None))
            stats["n_pods_reused"] = 0
        stats["n_pods"] = len(asg.pods)
        stats["t_podding"] = _time.perf_counter() - t0

        # decide phase: structural digests + synonym lookups; no payload
        # bytes move yet.  With a reused assignment, only pods touched by
        # dirty chunks or changed scalar values re-hash their digest; the
        # rest reuse the previous save's digest (bit-identical: the digest
        # is a pure function of unchanged inputs).
        t0 = _time.perf_counter()
        touched_pods = None
        if pods_reused and self._pod_digests:
            touched_pods = set()
            for key in report.dirty:
                nid = graph.by_key.get(key)
                if nid is not None:
                    touched_pods.add(asg.node_pod[nid])
            for key in (ginfo.scalar_changed_keys if ginfo else ()):
                nid = graph.by_key.get(key)
                if nid is not None:
                    touched_pods.add(asg.node_pod[nid])
        pods_meta: Dict[int, Dict[str, Any]] = {}
        written = aliased = digests_reused = 0
        bytes_before = self.store.total_bytes()
        new_digests: Dict[int, bytes] = {}
        to_write: List[tuple] = []        # (pid, pod, dig_hex, digest)
        for pid, pod in asg.pods.items():
            if touched_pods is not None and pid not in touched_pods \
                    and pid in self._pod_digests:
                digest = self._pod_digests[pid]
                digests_reused += 1
            else:
                digest = pod_structural_digest(pod, graph, asg,
                                               report.digests)
            new_digests[pid] = digest
            dig_hex = digest.hex()
            skip = False
            if self.enable_cd:
                with self.saver.l_ns:
                    ref = self.thesaurus.lookup(digest)
                if ref is not None:
                    skip = True           # synonymous pod (§4.2)
            if not skip:
                if not self.enable_cd:
                    # NoCD baseline: every save writes unconditionally
                    # under a unique key (true snapshot cost, no dedup).
                    h = hashlib.blake2b(digest, digest_size=16,
                                        person=b"nocd")
                    h.update(time_id.to_bytes(8, "little"))
                    dig_hex = h.hexdigest()
                to_write.append((pid, pod, dig_hex, digest))
            else:
                aliased += 1
            pods_meta[pid] = {
                "d": dig_hex,
                "pages": (asg.memo.pods[pid].pages
                          if pid in asg.memo.pods else []),
                "n": len(pod.node_ids),
            }
        self._pod_digests = new_digests
        stats["n_pod_digests_reused"] = digests_reused
        stats["t_decide"] = _time.perf_counter() - t0

        # gather phase.  Fused path: payload bytes of speculated chunks
        # already arrived with the digest fetch; only mispredicted chunks
        # pay one corrective batched fetch (zero when speculation covered
        # every written pod — the single-sync save).  Non-fused: ONE
        # batched device fetch for every chunk of every dirty pod (clean
        # pods never touch the device either way).
        t0 = _time.perf_counter()
        gather_nodes = [graph.node(nid) for _, pod, _, _ in to_write
                        for nid in pod.node_ids]
        if self.fused:
            chunk_bytes_of, gather_syncs = fused_chunk_fetch(
                graph, gather_nodes, report.payload)
            stats["n_corrective_syncs"] = gather_syncs
        else:
            chunk_bytes_of, gather_syncs = batched_chunk_fetch(
                graph, gather_nodes)
        stats["t_gather"] = _time.perf_counter() - t0
        stats["n_gather_syncs"] = gather_syncs

        # write phase: serialize + store from the prefetched host bytes.
        # Each store write retries transient I/O errors with backoff
        # (retry_policy); puts are idempotent — a pod is content-addressed
        # and the rename is atomic — so a retried step never double-
        # applies.
        t0 = _time.perf_counter()
        n_retries = 0
        for pid, pod, dig_hex, digest in to_write:
            data = serialize_pod(pod, graph, asg, chunk_bytes_of)

            def put_one(dig_hex=dig_hex, data=data, digest=digest) -> bool:
                with self.saver.l_ns:
                    if self.enable_cd:
                        fresh = self.store.put_pod(dig_hex, data)
                        self.thesaurus.insert(digest, dig_hex)
                        return fresh
                    self.store.put_pod(dig_hex, data)
                    return True

            fresh, nr = call_with_retries(put_one, self.retry_policy)
            n_retries += nr
            if fresh:
                written += 1
            else:
                aliased += 1              # disk-level synonym
        stats["t_write"] = _time.perf_counter() - t0
        stats["n_retries"] = n_retries
        stats["pods_written"] = written
        stats["pods_aliased"] = aliased
        stats["bytes_written"] = self.store.total_bytes() - bytes_before

        manifest = {
            "time_id": time_id,
            "parent": parent,
            "root_pod": asg.root_pod,
            "page_size": self.memo_page_size,
            "pods": {str(pid): meta for pid, meta in pods_meta.items()},
            # the save's full chunk-digest table, so a later delta-aware
            # checkout can prime change detection without re-hashing
            "chunks": pack_digest_table(report.digests),
            "stats": {k: v for k, v in stats.items()
                      if isinstance(v, (int, float, str))},
        }

        def commit() -> None:
            with self.saver.l_ns:
                # the manifest put is the data commit point; the refs CAS
                # in record() is the visibility commit point.  Both are
                # idempotent, so the pair is safe to retry as a unit on
                # transient I/O errors.
                self.store.put_manifest(time_id, manifest)
                self.versions.record(time_id, parent, branch=branch)

        _, nr = call_with_retries(commit, self.retry_policy)
        stats["n_retries"] = n_retries + nr
        self._prev_pods = asg
        self._prev_graph = graph
        self.save_stats.append(stats)

    # ------------------------------------------------------------------
    # load
    # ------------------------------------------------------------------
    def _open(self, time_id: Optional[TimeID]) -> tuple:
        with self.saver.l_ns:
            if time_id is None:
                tids = self.store.list_time_ids()
                if not tids:
                    raise FileNotFoundError("no checkpoints in store")
                time_id = tids[-1]
            manifest = self.store.get_manifest(time_id)
        memo, digests = open_manifest(manifest)

        def fetch(pod_id: int) -> bytes:
            return self.store.get_pod(digests[pod_id])

        return manifest, Unpodder(memo, fetch, device=self.device)

    def load(self, names: Optional[Set[str]] = None,
             time_id: Optional[TimeID] = None,
             like: Any = None) -> Any:
        """Restore variables as tensors on the instance's device.
        `names=None` loads the full namespace; otherwise only pods
        reachable from the requested variables are read (partial
        loading, §3.1)."""
        manifest, up = self._open(time_id)
        root_pod = manifest["root_pod"]
        root_entry = up.entry(root_pod, 0)
        names_avail = root_entry["m"]["names"]
        out: Dict[str, Any] = {}
        for name, vid in zip(names_avail, root_entry["r"]):
            if names is not None and name not in names:
                continue
            cp, cl = up.resolve(root_pod, vid)
            out[name] = up.value(cp, cl)
        self.last_load_pods = len(up.loaded_pods)
        if like is not None:
            return reflow(like, out)
        return out

    # ------------------------------------------------------------------
    # versioning
    # ------------------------------------------------------------------
    def branch(self, name: str, at: Any = None) -> TimeID:
        """Create branch `name` (at HEAD unless `at` gives a ref/TimeID)
        and switch to it: subsequent saves advance the new branch."""
        self.wait()
        with self.saver.l_ns:
            return self.versions.create_branch(name, at=at)

    def tag(self, name: str, at: Any = None) -> TimeID:
        """Pin a commit under an immutable name."""
        self.wait()
        with self.saver.l_ns:
            return self.versions.create_tag(name, at=at)

    def log(self, ref: Any = None, limit: Optional[int] = None):
        """First-parent history of a ref (default HEAD), newest first."""
        self.wait()
        return self.versions.log(ref, limit=limit)

    def checkout(self, ref: Any = None, *, like: Any = None) -> Any:
        raise _not_ported("checkout", "version/checkout.py item")

    def diff(self, a: Any, b: Any):
        raise _not_ported("diff", "version/checkout.py item")

    def gc(self, *, dry_run: bool = False, full: Optional[bool] = None):
        raise _not_ported("gc", "version/gc.py item")

    def evict_branch(self, name: str, *, dry_run: bool = False):
        raise _not_ported("evict_branch", "version/refcount.py item")


def reflow(like: Any, loaded: Dict[str, Any]) -> Any:
    """Re-flow loaded values into the structure of `like` (so custom
    containers survive a round-trip).

    Tuples are rebuilt positionally; namedtuple-style containers (anything
    exposing `_fields`) are reconstructed with positional-star args, since
    their constructors take fields, not an iterable.
    """
    def walk(template: Any, value: Any) -> Any:
        if isinstance(template, dict):
            return {k: walk(template[k], value[k]) for k in template}
        if isinstance(template, (list, tuple)) and not hasattr(template, "shape"):
            t = type(template)
            vals = [walk(t_i, value[str(i)] if isinstance(value, dict) else value[i])
                    for i, t_i in enumerate(template)]
            if hasattr(template, "_fields"):   # namedtuple-style
                return t(*vals)
            return t(vals)
        return value

    return walk(like, loaded)
