"""Batched, size-bucketed fingerprint dispatch (§4.2 hot path, amortized).

The per-leaf digest path (`ops.leaf_fingerprint`) pays one kernel launch
and one blocking fetch *per leaf per save*.  For a real training state
with hundreds of leaves that launch/sync overhead dominates the actual
hashing.  This module amortizes all of it across the whole object graph:

  * **Planner** — every chunk of every leaf is assigned a slot
    (bucket, row) where the bucket is the power-of-two word width
    ``pow2ceil(words_per_chunk)`` clamped to ``MIN_BUCKET_WORDS``.  Mixed
    dtypes and ragged leaves land in the same bucket as long as their
    chunk word-widths round to the same power of two; per-row true byte
    lengths are folded into the digest exactly as in the per-leaf path,
    so bucket padding is digest-neutral.  Row counts are padded to a
    power of two so bucket shapes repeat across saves.  Plans equal the
    reference package's field for field.
  * **Packer** — plain tensor copies: every leaf's int32 word stream is
    written onto its rows of a zeroed (padded_rows, width) bucket matrix.
  * **Dispatch** — one kernel launch per bucket
    (`fingerprint.fingerprint_words`).
  * **Fetch** — all (C, 4) digest rows of all buckets leave the device in
    a **single** `ops.fetch_to_host` at the end of the save (the
    single-sync contract; `DigestResult.n_syncs` reports it).

The **fused single-sync** path (`digest_leaves_fused`) goes one step
further: the previous save's digest table stays *resident on the device*
(`DeviceTable` — per-bucket (padded_rows, 4) tensors in slot order), the
compare-against-previous runs inside the bucket kernel
(`fingerprint.fingerprint_words_cmp` emits digests **plus** a dirty flag
per row), and an `index_select` compacts the packed word rows of likely-
dirty chunks into dense per-bucket payload buffers — so digests, dirty
flags and dirty-chunk payload all come back in **one** fetch.  Because
rows are packed little-endian word streams and chunk boundaries are
4-byte aligned (`core.graph.chunk_grid`), a fetched row's first
`true_length` bytes ARE the chunk's payload bytes.  In the steady state
the device table is the previous save's own kernel output; when the plan
changes or the table was imported, it is re-seeded from the host table
with non-blocking uploads — never a blocking fetch.

Host (numpy) leaves run through the same planner with the numpy digest
twin and cost no sync.  Device leaves must lie on the caller's device;
on a CPU device the kernels' plain versions run, so the CPU follows the
same path and pays the same (counted) fetches.

The per-leaf functions in ops.py remain the parity oracle: batched
digests are bit-identical.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import ObjectGraph, chunk_grid, dtype_name, itemsize_of
from .fingerprint import fingerprint_words, fingerprint_words_cmp
from .ops import (fetch_to_host, is_host_array, to_device, to_words,
                  to_words_np)
from .ref import fingerprint_words_np

#: smallest bucket word width (512 B) — tiny leaves share one bucket
MIN_BUCKET_WORDS = 128
#: rows per block and inner tile width of the reference's TPU grid; kept
#: in `BucketSpec` so plans equal the reference's, unused by the CUDA kernel
MAX_BLOCK_ROWS = 64
TILE = 4096


def pow2ceil(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one leaf's chunks land: rows [row0, row0+n_chunks) of a bucket."""
    key: str
    shape: Tuple[int, ...]
    dtype: str
    n_chunks: int
    elems: int               # elements per full chunk (flat-range grid)
    words_per_chunk: int     # uint32 word width of a full chunk
    nbytes: int              # total leaf payload bytes
    bucket: int              # bucket word width (power of two)
    row0: int                # first row within the bucket


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    width: int               # words per row (power of two)
    n_rows: int              # real chunk rows
    padded_rows: int         # pow2ceil(n_rows) — shape-stable across saves
    block_rows: int          # reference TPU grid: rows per grid cell
    tile: int                # reference TPU grid: inner tile width


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    leaves: Tuple[LeafSlot, ...]
    buckets: Tuple[BucketSpec, ...]   # ascending width; rows bucket-major
    chunk_bytes: int

    @property
    def n_chunks(self) -> int:
        return sum(b.n_rows for b in self.buckets)


@functools.lru_cache(maxsize=512)
def plan_leaves(specs: Tuple[Tuple[str, Tuple[int, ...], str], ...],
                chunk_bytes: int) -> BatchPlan:
    """Pack chunk slots of the given (key, shape, dtype name) leaves into
    power-of-two word-width buckets.  Deterministic: slots depend only on
    the spec sequence and chunk_bytes, so plans are shared across saves."""
    slots: List[LeafSlot] = []
    rows_in_bucket: Dict[int, int] = {}
    for key, shape, dtype in specs:
        itemsize = itemsize_of(dtype)
        elems, n_chunks = chunk_grid(shape, dtype, chunk_bytes)
        total = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = total * itemsize
        wpc = max(1, -(-(elems * itemsize) // 4))
        bucket = max(MIN_BUCKET_WORDS, pow2ceil(wpc))
        row0 = rows_in_bucket.get(bucket, 0)
        rows_in_bucket[bucket] = row0 + n_chunks
        slots.append(LeafSlot(key=key, shape=tuple(shape), dtype=str(dtype),
                              n_chunks=n_chunks, elems=elems,
                              words_per_chunk=wpc, nbytes=nbytes,
                              bucket=bucket, row0=row0))
    buckets = []
    for width in sorted(rows_in_bucket):
        n_rows = rows_in_bucket[width]
        padded = pow2ceil(n_rows)
        block = min(MAX_BLOCK_ROWS, padded)
        buckets.append(BucketSpec(width=width, n_rows=n_rows,
                                  padded_rows=padded, block_rows=block,
                                  tile=min(TILE, width)))
    return BatchPlan(leaves=tuple(slots), buckets=tuple(buckets),
                     chunk_bytes=chunk_bytes)


@functools.lru_cache(maxsize=512)
def _plan_slots(plan: BatchPlan) -> Tuple[Tuple[str, ...],
                                          Tuple[Tuple[str, int], ...]]:
    """(chunk keys in slot order, (leaf key, global row offset) pairs).

    Slot order is bucket-major (ascending width), then row order within
    the bucket.  Cached per plan so steady-state saves rebuild nothing.
    """
    base: Dict[int, int] = {}
    off = 0
    for b in plan.buckets:
        base[b.width] = off
        off += b.n_rows
    ordered = sorted(plan.leaves, key=lambda s: (s.bucket, s.row0))
    keys: List[str] = []
    leaf_offsets: List[Tuple[str, int]] = []
    for s in ordered:
        row = base[s.bucket] + s.row0
        leaf_offsets.append((s.key, row))
        keys.extend(f"{s.key}#[{ci}]" for ci in range(s.n_chunks))
    return tuple(keys), tuple(leaf_offsets)


@functools.lru_cache(maxsize=512)
def _plan_lengths(plan: BatchPlan) -> Tuple[np.ndarray, ...]:
    """Per-bucket true-byte-length columns (padded rows fold length 0)."""
    out = {b.width: np.zeros((b.padded_rows,), np.uint32)
           for b in plan.buckets}
    for s in plan.leaves:
        itemsize = itemsize_of(s.dtype)
        lens = np.full((s.n_chunks,), s.elems * itemsize, np.uint32)
        lens[-1] = s.nbytes - (s.n_chunks - 1) * s.elems * itemsize
        out[s.bucket][s.row0:s.row0 + s.n_chunks] = lens
    return tuple(out[b.width] for b in plan.buckets)


@functools.lru_cache(maxsize=512)
def _plan_lengths_on(plan: BatchPlan,
                     device: torch.device) -> Tuple[torch.Tensor, ...]:
    """`_plan_lengths` as int32 tensors on `device` (uploaded once)."""
    return tuple(to_device(lens.view(np.int32), device)
                 for lens in _plan_lengths(plan))


def _pack(plan: BatchPlan, arrays: Sequence[torch.Tensor],
          device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Leaf tensors (plan order) -> per-bucket int32 (padded_rows, width)
    word matrices: row r of a leaf holds the words of its chunk r,
    zero-padded; padded rows are zero."""
    mats = {b.width: torch.zeros((b.padded_rows, b.width),
                                 dtype=torch.int32, device=device)
            for b in plan.buckets}
    for slot, arr in zip(plan.leaves, arrays):
        w = to_words(arr)
        m = mats[slot.bucket]
        wpc = slot.words_per_chunk
        full = w.numel() // wpc
        if full:
            m[slot.row0:slot.row0 + full, :wpc] = w[:full * wpc].view(full, wpc)
        rest = w.numel() - full * wpc
        if rest:
            m[slot.row0 + full, :rest] = w[full * wpc:]
    return tuple(mats[b.width] for b in plan.buckets)


def _pack_leaf_words_np(slot: LeafSlot, arr: np.ndarray) -> np.ndarray:
    w = to_words_np(arr)
    need = slot.n_chunks * slot.words_per_chunk
    if w.shape[0] != need:
        w = np.pad(w, (0, need - w.shape[0]))
    mat = w.reshape(slot.n_chunks, slot.words_per_chunk)
    if slot.words_per_chunk != slot.bucket:
        mat = np.pad(mat, ((0, 0), (0, slot.bucket - slot.words_per_chunk)))
    return mat


@dataclasses.dataclass
class DigestResult:
    """Digests of a leaf set in slot order (device buckets first)."""
    keys: List[str]                    # chunk keys, aligned with mat rows
    mat: np.ndarray                    # uint32 (C, 4)
    n_syncs: int                       # blocking fetches issued (0 or 1)
    leaf_rows: Dict[str, int]          # leaf key -> first row of its chunks

    def row_of(self, leaf_key: str, chunk_index: int) -> int:
        return self.leaf_rows[leaf_key] + chunk_index


@dataclasses.dataclass
class FusedDigestResult(DigestResult):
    """DigestResult plus the fused-pass extras.

    `dirty` is int8 per slot row: 1 dirty, 0 clean (kernel-compared
    against a trusted previous digest), -1 unknown (host-group rows — the
    caller falls back to its host compare for those).  `payload` maps
    chunk keys of speculatively compacted rows to their exact payload
    bytes (what `serialize_pod` would have gathered).
    """
    dirty: Optional[np.ndarray] = None
    payload: Dict[str, bytes] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DeviceTable:
    """Previous digest table resident on the device, in bucket-slot order.

    In the steady state `digs` are the previous save's own kernel output
    tensors (never re-uploaded); `valid` flags the rows whose previous
    digest is real — a row seeded without a host entry compares against
    zeros and is forced dirty by the caller.
    """
    plan: BatchPlan
    digs: List[torch.Tensor]           # per bucket: int32 (padded_rows, 4)
    valid: List[np.ndarray]            # per bucket: bool (n_rows,)


def seed_device_table(plan: BatchPlan, lookup,
                      device: torch.device) -> DeviceTable:
    """Build the device-resident previous-digest table for `plan` from a
    host digest lookup (chunk key -> 16-byte digest, or None when never
    seen).  One non-blocking upload per bucket — no blocking sync."""
    keys, _ = _plan_slots(plan)
    digs: List[torch.Tensor] = []
    valid: List[np.ndarray] = []
    off = 0
    for b in plan.buckets:
        mat = np.zeros((b.padded_rows, 4), np.uint32)
        v = np.zeros((b.n_rows,), bool)
        for r in range(b.n_rows):
            d = lookup(keys[off + r])
            if d is not None:
                mat[r] = np.frombuffer(d, np.uint32)
                v[r] = True
        digs.append(to_device(mat.view(np.int32), device))
        valid.append(v)
        off += b.n_rows
    return DeviceTable(plan=plan, digs=digs, valid=valid)


def _split(items: Sequence[Tuple[str, Any]], device: Optional[torch.device]
           ) -> Tuple[List[Tuple[str, Any]], List[Tuple[str, Any]],
                      Optional[torch.device]]:
    """(device items, host items, device).  Every tensor must lie on
    `device` (default: the first tensor's device)."""
    dev: List[Tuple[str, Any]] = []
    host: List[Tuple[str, Any]] = []
    for key, arr in items:
        if is_host_array(arr):
            host.append((key, np.asarray(arr)))
            continue
        if device is None:
            device = arr.device
        if arr.device != device:
            raise ValueError(f"leaf {key!r} is on {arr.device}, not on the "
                             f"store's device {device}")
        dev.append((key, arr))
    return dev, host, device


def _specs(group: Sequence[Tuple[str, Any]]):
    return tuple((k, tuple(int(d) for d in a.shape), dtype_name(a.dtype))
                 for k, a in group)


def _digest_device(plan: BatchPlan, arrays: Sequence[torch.Tensor], *,
                   seed: int, device: torch.device) -> List[np.ndarray]:
    packed = _pack(plan, arrays, device)
    lengths = _plan_lengths_on(plan, device)
    digs = [fingerprint_words(words, lens, seed=seed)
            for words, lens in zip(packed, lengths)]
    host = fetch_to_host(digs)         # the ONE sync of the digest phase
    return [h.view(np.uint32).reshape(-1, 4)[:b.n_rows]
            for b, h in zip(plan.buckets, host)]


def _digest_host(plan: BatchPlan, arrays: Sequence[np.ndarray], *,
                 seed: int) -> List[np.ndarray]:
    lengths = _plan_lengths(plan)
    by_bucket: Dict[int, List[Tuple[int, np.ndarray]]] = {
        b.width: [] for b in plan.buckets}
    for slot, arr in zip(plan.leaves, arrays):
        by_bucket[slot.bucket].append((slot.row0,
                                       _pack_leaf_words_np(slot, arr)))
    out = []
    for b, lens in zip(plan.buckets, lengths):
        mats = [m for _, m in sorted(by_bucket[b.width], key=lambda t: t[0])]
        words = np.concatenate(mats, axis=0) if len(mats) > 1 else mats[0]
        out.append(fingerprint_words_np(words, lens[:b.n_rows], seed=seed))
    return out


def digest_leaves(items: Sequence[Tuple[str, Any]], *, chunk_bytes: int,
                  seed: int = 0,
                  device: Optional[torch.device] = None) -> DigestResult:
    """Digest every chunk of the given (leaf key, array) pairs.

    Tensor leaves go through the bucketed kernel path and cost one
    `fetch_to_host` total; host (numpy) leaves go through the bucketed
    numpy twin and cost zero.  Result rows are bucket-major with all
    device buckets first.
    """
    dev, host, device = _split(items, device)
    keys: List[str] = []
    mats: List[np.ndarray] = []
    leaf_rows: Dict[str, int] = {}
    n_syncs = 0
    offset = 0
    for group, is_dev in ((dev, True), (host, False)):
        if not group:
            continue
        plan = plan_leaves(_specs(group), chunk_bytes)
        arrays = [a for _, a in group]
        if is_dev:
            bucket_digs = _digest_device(plan, arrays, seed=seed,
                                         device=device)
            n_syncs += 1
        else:
            bucket_digs = _digest_host(plan, arrays, seed=seed)
        plan_keys, plan_offsets = _plan_slots(plan)
        keys.extend(plan_keys)
        mats.extend(bucket_digs)
        for lkey, row in plan_offsets:
            leaf_rows[lkey] = offset + row
        offset += plan.n_chunks

    mat = (np.concatenate(mats, axis=0) if mats
           else np.zeros((0, 4), np.uint32))
    return DigestResult(keys=keys, mat=mat, n_syncs=n_syncs,
                        leaf_rows=leaf_rows)


def _digest_device_fused(plan: BatchPlan, arrays: Sequence[torch.Tensor], *,
                         seed: int, device: torch.device,
                         table: DeviceTable,
                         spec_local: Dict[int, np.ndarray]):
    """Fused per-bucket digest+compare plus speculative row compaction.

    Returns (digest mats, dirty masks, {bucket idx: fetched spec rows as
    uint8 (n, width*4)}, new DeviceTable) after exactly ONE
    `fetch_to_host` covering all three result classes.
    """
    packed = _pack(plan, arrays, device)
    lengths = _plan_lengths_on(plan, device)
    digs_dev: List[torch.Tensor] = []
    masks_dev: List[torch.Tensor] = []
    spec_dev: List[Tuple[int, torch.Tensor]] = []
    for bi, (words, lens) in enumerate(zip(packed, lengths)):
        d, m = fingerprint_words_cmp(words, lens, table.digs[bi], seed=seed)
        digs_dev.append(d)
        masks_dev.append(m)
        rows = spec_local.get(bi)
        if rows is not None and len(rows):
            # compaction: gather the packed word rows of the speculated
            # chunks into one dense (n_spec, width) buffer.  Rows are
            # already the chunk's word stream, so the buffer IS the
            # payload (true byte lengths slice off padding on the host).
            spec_dev.append((bi, words.index_select(0, to_device(rows,
                                                                 device))))
    host = fetch_to_host(digs_dev + masks_dev
                         + [m for _, m in spec_dev])   # the ONE sync
    nb = len(plan.buckets)
    dig_mats = [h.view(np.uint32).reshape(-1, 4)[:b.n_rows]
                for b, h in zip(plan.buckets, host[:nb])]
    masks = [h.view(np.uint32)[:b.n_rows].astype(np.uint8)
             for b, h in zip(plan.buckets, host[nb:2 * nb])]
    spec_rows = {bi: h.reshape(-1, plan.buckets[bi].width * 4)
                 for (bi, _), h in zip(spec_dev, host[2 * nb:])}
    # padded digest rows stay on the device as the next save's prev
    # table: every digested row is now trusted.
    new_table = DeviceTable(
        plan=plan, digs=digs_dev,
        valid=[np.ones((b.n_rows,), bool) for b in plan.buckets])
    return dig_mats, masks, spec_rows, new_table


def digest_leaves_fused(items: Sequence[Tuple[str, Any]], *,
                        chunk_bytes: int, seed: int = 0,
                        table: Optional[DeviceTable] = None,
                        lookup=None,
                        spec_keys: Optional[set] = None,
                        device: Optional[torch.device] = None,
                        ) -> Tuple[FusedDigestResult, Optional[DeviceTable]]:
    """Fused single-sync digest of the given (leaf key, array) pairs.

    Tensor leaves run the fused digest+compare kernel against the
    device-resident previous table (`table` when its plan matches this
    call's leaf specs, else re-seeded from `lookup`), with the packed
    rows of `spec_keys` chunks compacted into the same fetch — ONE
    blocking `fetch_to_host` total.  Host leaves take the numpy twin
    (dirty = -1: the caller's host compare decides).

    Returns (result, new device table to carry to the next save).
    """
    dev, host, device = _split(items, device)
    keys: List[str] = []
    mats: List[np.ndarray] = []
    dirty_parts: List[np.ndarray] = []
    leaf_rows: Dict[str, int] = {}
    payload: Dict[str, bytes] = {}
    new_table = table                  # preserved when no device leaves
    n_syncs = 0
    offset = 0
    spec_keys = spec_keys or set()
    for group, is_dev in ((dev, True), (host, False)):
        if not group:
            continue
        plan = plan_leaves(_specs(group), chunk_bytes)
        arrays = [a for _, a in group]
        plan_keys, plan_offsets = _plan_slots(plan)
        if is_dev:
            if (table is None or table.plan is not plan
                    or table.digs[0].device != device):
                # plan changed (or table imported/never built): re-seed
                # from the host table; rows it has never seen compare
                # against zeros and are forced dirty below.
                table = seed_device_table(
                    plan, lookup if lookup is not None else lambda k: None,
                    device)
            # speculated chunk keys -> (bucket, local row)
            spec_local: Dict[int, List[int]] = {}
            bucket_base: List[int] = []
            off = 0
            for b in plan.buckets:
                bucket_base.append(off)
                off += b.n_rows
            if spec_keys:
                row_of = {k: r for r, k in enumerate(plan_keys)}
                for k in spec_keys:
                    r = row_of.get(k)
                    if r is None:
                        continue
                    for bi in range(len(plan.buckets) - 1, -1, -1):
                        if r >= bucket_base[bi]:
                            spec_local.setdefault(bi, []).append(
                                r - bucket_base[bi])
                            break
            spec_arr = {bi: np.asarray(sorted(rows), np.int64)
                        for bi, rows in spec_local.items()}
            # pad each gather to a power-of-two row count (repeating the
            # first row) so gather shapes repeat when the speculation set
            # fluctuates; extra rows are fetched and dropped (payload
            # extraction walks only the real rows).
            spec_padded = {
                bi: np.concatenate(
                    [r, np.full(pow2ceil(len(r)) - len(r), r[0], np.int64)])
                for bi, r in spec_arr.items()}
            dig_mats, masks, spec_fetched, new_table = _digest_device_fused(
                plan, arrays, seed=seed, device=device, table=table,
                spec_local=spec_padded)
            n_syncs += 1
            lengths = _plan_lengths(plan)
            for bi, rows in spec_arr.items():
                fetched = spec_fetched[bi]
                lens = lengths[bi]
                for i, r in enumerate(rows):
                    key = plan_keys[bucket_base[bi] + int(r)]
                    payload[key] = fetched[i, :int(lens[r])].tobytes()
            for bi, (b, m) in enumerate(zip(plan.buckets, masks)):
                d = m.astype(np.int8)
                d[~table.valid[bi]] = 1      # no trusted prev: dirty
                dirty_parts.append(d)
            mats.extend(dig_mats)
        else:
            mats.extend(_digest_host(plan, arrays, seed=seed))
            dirty_parts.append(np.full((plan.n_chunks,), -1, np.int8))
        keys.extend(plan_keys)
        for lkey, row in plan_offsets:
            leaf_rows[lkey] = offset + row
        offset += plan.n_chunks

    mat = (np.concatenate(mats, axis=0) if mats
           else np.zeros((0, 4), np.uint32))
    dirty = (np.concatenate(dirty_parts) if dirty_parts
             else np.zeros((0,), np.int8))
    res = FusedDigestResult(keys=keys, mat=mat, n_syncs=n_syncs,
                            leaf_rows=leaf_rows, dirty=dirty,
                            payload=payload)
    return res, new_table


def tree_fingerprint_batched(graph: ObjectGraph, *, active_leaf_paths=None,
                             chunk_bytes: int = 1 << 22, seed: int = 0,
                             device: Optional[torch.device] = None
                             ) -> Tuple[Dict[str, bytes], int]:
    """Batched drop-in for `ops.tree_fingerprint`: {chunk key: 16-byte
    digest} for every (active) leaf, plus the number of blocking fetches
    paid (≤ 1)."""
    items = []
    for leaf in graph.leaf_nodes():
        if active_leaf_paths is not None and leaf.key not in active_leaf_paths:
            continue
        items.append((leaf.key, graph.arrays[leaf.key]))
    res = digest_leaves(items, chunk_bytes=chunk_bytes, seed=seed,
                        device=device)
    buf = res.mat.tobytes()
    out = {k: buf[16 * i:16 * (i + 1)] for i, k in enumerate(res.keys)}
    return out, res.n_syncs
