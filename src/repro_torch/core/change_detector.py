"""Change detector (paper §4.2), device half + host bookkeeping.

Per save, the detector digests every *active* chunk and compares against
the previous digest table.  Inactive chunks inherit their previous digest
without being touched — the active-variable-filter guarantee (Thm 4.1)
makes that sound.

The digest phase runs through the batched, size-bucketed engine
(`kernels.batch`): one kernel launch per word-width bucket over all
chunks of all leaves, and a **single** blocking fetch
(`kernels.ops.fetch_to_host`) for all (C, 4) digest rows per save — no
per-leaf host syncs.

With ``fused=True`` (default) the *compare* also runs on the device: the
previous digest table stays resident on the device (`kernels.batch.
DeviceTable`, in the steady state simply the previous save's kernel
output), the bucket kernel emits a dirty flag per row alongside the
digests, and the packed word rows of *speculated* chunks (the caller's
flip-EMA prediction, see `volatility.FlipTracker`) are compacted into
the same fetch — so digests, dirty flags, and likely-dirty payload bytes
all arrive in the one fetch.  The host-side numpy compare against
``self._table`` survives as the fallback rung for rows the kernel did
not cover (host-numpy leaves, ``fused=False``), and the host table
itself remains the source of truth persisted into manifests.

Set ``batched=False`` to fall back to the per-leaf oracle path
(`ops.leaf_fingerprint`).

Tensor leaves must lie on the detector's ``device``; on a CPU device the
kernels' plain versions run, so the CPU takes the same path and pays the
same fetches.

Output: the new digest table + the set of dirty chunk keys + speculated
payload bytes + the number of blocking fetches paid.  Dirty chunks
determine dirty pods; clean pods become synonym records (no payload
write, no device->host transfer).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from ..kernels import batch as kbatch
from ..kernels import ops as kops
from .graph import CHUNK, Node, ObjectGraph
from .trace import span


def pack_digest_table(digests: Dict[str, bytes]) -> Dict[str, bytes]:
    """Compact a chunk-keyed digest table for manifest persistence.

    Chunk keys repeat their leaf path per chunk (`lkey#[ci]`), so the
    persisted form concatenates the 16-byte digests of each leaf in
    chunk-index order under the leaf key alone: {leaf_key: digests_blob}.
    """
    per_leaf: Dict[str, List[Tuple[int, bytes]]] = {}
    for key, dig in digests.items():
        lkey, _, ci = key.rpartition("#[")
        per_leaf.setdefault(lkey, []).append((int(ci[:-1]), dig))
    return {lkey: b"".join(d for _, d in sorted(rows))
            for lkey, rows in per_leaf.items()}


def unpack_digest_table(packed: Dict[str, bytes]) -> Dict[str, bytes]:
    """Inverse of `pack_digest_table`: back to {chunk_key: 16-byte digest}."""
    out: Dict[str, bytes] = {}
    for lkey, blob in packed.items():
        for ci in range(len(blob) // 16):
            out[f"{lkey}#[{ci}]"] = blob[16 * ci:16 * (ci + 1)]
    return out


@dataclasses.dataclass
class ChangeReport:
    digests: Dict[str, bytes]          # chunk key -> 16-byte digest
    dirty: Set[str]                    # dirty chunk keys
    active_chunks: int = 0
    skipped_chunks: int = 0
    n_syncs: int = 0                   # blocking device fetches this save
    #: speculatively prefetched payload bytes (chunk key -> exact bytes),
    #: compacted into the digest fetch by the fused path
    payload: Dict[str, bytes] = dataclasses.field(default_factory=dict)
    n_spec_hits: int = 0               # dirty chunks whose bytes were fetched
    n_spec_misses: int = 0             # dirty chunks needing a corrective gather
    fused_rows: int = 0                # slot rows dirty-resolved on device
    #: chunks and dirty chunks of the graph by leaf group, the last
    #: component of the leaf's path ("k", "v", "conv", "ssm", ...)
    chunks_by_group: Dict[str, int] = dataclasses.field(default_factory=dict)
    dirty_by_group: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: per digested row, whether its chunk is dirty; the first row of
    #: each digested leaf (`kbatch.DigestResult.leaf_rows`)
    row_changed: Optional[np.ndarray] = None
    leaf_rows: Dict[str, int] = dataclasses.field(default_factory=dict)


class ChangeDetector:
    def __init__(self, *, chunk_bytes: int = 1 << 22, seed: int = 0,
                 batched: bool = True,
                 fused: bool = True, device: Any = "cuda"):
        self.chunk_bytes = chunk_bytes
        self.seed = seed
        self.device = kops.resolve_device(device)
        self.batched = batched
        self.fused = fused and batched
        # persistent key-indexed digest table: uint32 (N, 4) + key -> row
        self._table: Optional[np.ndarray] = None
        self._index: Dict[str, int] = {}
        # device-resident mirror of the previous digest table in bucket-
        # slot order (fused path); None = re-seed from the host table on
        # the next detect (one async H2D upload, no blocking sync).
        self._dev_table = None
        # leaf key -> chunk count fully present in the table (fast check
        # for "has every chunk of this inactive leaf been seen before")
        self._seen_leaves: Dict[str, int] = {}

    # ------------------------------------------------------------------
    # digest-table export/import (delta-aware checkout)
    # ------------------------------------------------------------------
    def export_table(self) -> Dict[str, bytes]:
        """Snapshot the persistent digest table as {chunk_key: digest}."""
        if self._table is None:
            return {}
        buf = self._table.tobytes()
        return {k: buf[16 * i:16 * (i + 1)] for k, i in self._index.items()}

    def import_table(self, digests: Dict[str, bytes]) -> None:
        """Replace the persistent digest table wholesale.

        Used by delta-aware checkout: the target manifest carries the
        chunk digests of the committed state, so priming the table from it
        makes the very next `save()` diff against the *checked-out* state
        — only chunks actually mutated after the checkout come out dirty —
        without re-fingerprinting anything.

        The device-resident mirror is dropped: it reflects the pre-
        checkout state.  The next fused detect re-seeds the device table
        from the imported host table (`kernels.batch.seed_device_table`,
        async upload), so the first post-checkout save still runs the
        fused single-sync path — never a silent host-compare fallback.
        """
        self._dev_table = None
        keys = list(digests)
        table = np.empty((len(keys), 4), np.uint32)
        seen_leaves: Dict[str, int] = {}
        for i, key in enumerate(keys):
            table[i] = np.frombuffer(digests[key], np.uint32)
            lkey = key.rpartition("#[")[0]
            seen_leaves[lkey] = seen_leaves.get(lkey, 0) + 1
        self._table = table
        self._index = {k: i for i, k in enumerate(keys)}
        self._seen_leaves = seen_leaves

    # ------------------------------------------------------------------
    def _lookup_digest(self, key: str) -> Optional[bytes]:
        """Previous digest of a chunk key from the host table, or None."""
        i = self._index.get(key)
        if i is None or self._table is None:
            return None
        return self._table[i].tobytes()

    def _digest(self, leaves: List[Node], graph: ObjectGraph,
                speculate: Optional[Set[str]] = None,
                stats: Optional[Dict[str, Any]] = None
                ) -> kbatch.DigestResult:
        """Digest all chunks of `leaves` → slot-ordered DigestResult.

        Fused mode: bucketed digest+compare kernels against the device-
        resident previous table, speculated payloads compacted into the
        one device sync.  Batched mode: bucketed kernels + one device
        sync total.  Oracle mode: per-leaf kernel calls + one sync per
        device leaf.  The calls, launch to fetched result, are the span
        ``save.digest.call`` (``stats["t_digest_call"]``).
        """
        items = [(leaf.key, graph.arrays[leaf.key]) for leaf in leaves]
        with span("save.digest.call", stats, "t_digest_call"):
            if self.fused:
                res, self._dev_table = kbatch.digest_leaves_fused(
                    items, chunk_bytes=self.chunk_bytes, seed=self.seed,
                    table=self._dev_table,
                    lookup=self._lookup_digest, spec_keys=speculate,
                    device=self.device)
                return res
            if self.batched:
                return kbatch.digest_leaves(
                    items, chunk_bytes=self.chunk_bytes, seed=self.seed,
                    device=self.device)
            keys: List[str] = []
            mats: List[np.ndarray] = []
            leaf_rows: Dict[str, int] = {}
            n_syncs = 0
            row = 0
            for lkey, arr in items:
                if kops.is_host_array(arr):
                    dig = kops.leaf_fingerprint_np(
                        arr, chunk_bytes=self.chunk_bytes, seed=self.seed)
                else:
                    if arr.device != self.device:
                        raise ValueError(f"leaf {lkey!r} is on {arr.device}, "
                                         f"not on {self.device}")
                    dig = kops.leaf_fingerprint(
                        arr, chunk_bytes=self.chunk_bytes, seed=self.seed)
                    n_syncs += 1
                leaf_rows[lkey] = row
                keys.extend(f"{lkey}#[{ci}]" for ci in range(dig.shape[0]))
                mats.append(np.asarray(dig, np.uint32))
                row += dig.shape[0]
            mat = (np.concatenate(mats, axis=0) if mats
                   else np.zeros((0, 4), np.uint32))
            return kbatch.DigestResult(keys=keys, mat=mat, n_syncs=n_syncs,
                                       leaf_rows=leaf_rows)

    def verify(self, graph: ObjectGraph,
               speculate: Optional[Set[str]] = None) -> ChangeReport:
        """Digest every leaf of `graph` against the table and leave the
        table as it was.  ``dirty`` names the chunks whose bytes changed
        since the table was taken, ``digests`` are the current ones, and
        the payload of the `speculate` chunks rides along: the same one
        fetch a fused save pays.  Checkout uses it to find tensors the
        caller changed in place since the last save."""
        kept = (self._table, self._index, self._seen_leaves, self._dev_table)
        try:
            return self.detect(graph, None, speculate=speculate)
        finally:
            (self._table, self._index, self._seen_leaves,
             self._dev_table) = kept

    # ------------------------------------------------------------------
    def detect(self, graph: ObjectGraph,
               active_leaf_paths: Optional[Set[str]] = None,
               speculate: Optional[Set[str]] = None,
               stats: Optional[Dict[str, Any]] = None) -> ChangeReport:
        """Digest the chunks of `graph` against the previous table.
        `stats`, when given, receives ``t_digest_call`` (`_digest`)."""
        # 1. choose the leaves to digest: every active leaf, plus any
        # inactive leaf with chunks the table has never seen (those must
        # be digested now; their already-seen siblings still inherit).
        digest_leaves: List[Node] = []
        active_leaf_set: Set[str] = set()
        leaves = list(graph.leaf_nodes())
        for leaf in leaves:
            lkey = leaf.key
            if active_leaf_paths is None or lkey in active_leaf_paths:
                digest_leaves.append(leaf)
                active_leaf_set.add(lkey)
            elif self._seen_leaves.get(lkey) != len(leaf.children):
                digest_leaves.append(leaf)

        res = self._digest(digest_leaves, graph, speculate, stats)
        C = len(res.keys)

        # 2. dirtiness per slot row.  Fused path: the kernel already
        # compared against the device-resident previous table — trust its
        # bitmask for every row it covered.  Remaining rows (host leaves,
        # non-fused modes) take the vectorized host diff against the
        # persistent table; rows with no previous entry are dirty.
        changed = np.ones(C, dtype=bool)
        unknown = np.ones(C, dtype=bool)
        fused_rows = 0
        kernel_dirty = getattr(res, "dirty", None)
        if kernel_dirty is not None and C:
            known = kernel_dirty >= 0
            changed[known] = kernel_dirty[known] > 0
            unknown = ~known
            fused_rows = int(known.sum())
        if unknown.any() and self._table is not None:
            idx_unknown = np.nonzero(unknown)[0]
            prev_rows = np.fromiter(
                (self._index.get(res.keys[i], -1) for i in idx_unknown),
                dtype=np.int64, count=len(idx_unknown))
            have = prev_rows >= 0
            if have.any():
                sub = idx_unknown[have]
                changed[sub] = (res.mat[sub]
                                != self._table[prev_rows[have]]).any(axis=1)
        buf = res.mat.tobytes()
        chunks_by_group, dirty_by_group = _by_group(leaves, res.leaf_rows,
                                                    changed)

        # 3. assemble the new digest table + dirty set, walking chunk
        # nodes once.  Active chunks take the fresh digest; inactive
        # chunks inherit unless never seen (then the fresh digest of the
        # fallback-digested leaf is used and the chunk is dirty).
        digests: Dict[str, bytes] = {}
        dirty: Set[str] = set()
        new_keys: List[str] = []
        new_rows: List[int] = []        # rows into res.mat (or ~row into table)
        seen_leaves: Dict[str, int] = {}
        active = skipped = 0
        for node in graph.chunk_nodes():
            key = node.key
            lkey = "/".join(node.path)
            seen_leaves[lkey] = seen_leaves.get(lkey, 0) + 1
            if lkey in active_leaf_set:
                active += 1
                r = res.row_of(lkey, node.chunk_index)
                digests[key] = buf[16 * r:16 * (r + 1)]
                if changed[r]:
                    dirty.add(key)
                new_keys.append(key)
                new_rows.append(r)
            else:
                skipped += 1
                pr = self._index.get(key, -1)
                if pr >= 0:
                    digests[key] = self._table[pr].tobytes()
                    new_keys.append(key)
                    new_rows.append(~pr)    # negative: row of the OLD table
                else:
                    r = res.row_of(lkey, node.chunk_index)
                    digests[key] = buf[16 * r:16 * (r + 1)]
                    dirty.add(key)
                    new_keys.append(key)
                    new_rows.append(r)

        # 4. persist: gather new table rows vectorized (fresh rows from
        # res.mat, inherited rows from the old table).  The compact table
        # is the only digest state retained across saves.
        rows_arr = np.asarray(new_rows, np.int64)
        table = np.empty((len(new_keys), 4), np.uint32)
        fresh = rows_arr >= 0
        if fresh.any():
            table[fresh] = res.mat[rows_arr[fresh]]
        if (~fresh).any():
            table[~fresh] = self._table[~rows_arr[~fresh]]
        self._table = table
        self._index = {k: i for i, k in enumerate(new_keys)}
        self._seen_leaves = seen_leaves

        # 5. speculation accounting: payload rows that turned out dirty
        # are hits (their bytes already crossed the link); dirty chunks
        # outside the payload will need a corrective gather.
        payload = getattr(res, "payload", None) or {}
        hits = sum(1 for k in dirty if k in payload)
        return ChangeReport(digests=digests, dirty=dirty,
                            active_chunks=active, skipped_chunks=skipped,
                            n_syncs=res.n_syncs, payload=payload,
                            n_spec_hits=hits,
                            n_spec_misses=len(dirty) - hits,
                            fused_rows=fused_rows,
                            chunks_by_group=chunks_by_group,
                            dirty_by_group=dirty_by_group,
                            row_changed=changed, leaf_rows=res.leaf_rows)


def _by_group(leaves: List[Node], leaf_rows: Dict[str, int],
              changed: np.ndarray) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Chunks and dirty chunks of each leaf group (a leaf path's last
    component), counted per leaf from the rows' dirty flags: a digested
    leaf's dirty chunks are its rows flagged `changed`, and a leaf that
    was not digested inherits every digest, so none of its chunks is
    dirty."""
    chunks: Dict[str, int] = {}
    dirty: Dict[str, int] = {}
    for leaf in leaves:
        group = leaf.path[-1] if leaf.path else ""
        n = len(leaf.children)
        r0 = leaf_rows.get(leaf.key)
        d = 0 if r0 is None or not n else int(
            np.count_nonzero(changed[r0:r0 + n]))
        chunks[group] = chunks.get(group, 0) + n
        dirty[group] = dirty.get(group, 0) + d
    return chunks, dirty
