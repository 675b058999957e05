"""Chunk fingerprint digest on the GPU: wrappers around the Hopper kernels.

The digest (ref.py) is computed on the device, so only 16 bytes per
chunk, a dirty flag and the speculated dirty rows ever cross to the host
(the single-sync save contract, see batch.py).  Two kernels, one CUDA
source (`csrc/fingerprint.cu`):

  * `fingerprint_leaves_cmp` — K1, fused digest-and-compare: digests
    every chunk row of a save where it lies in its leaf (a `RowTable`
    says where), compares it with the previous save's digest row and
    emits a per-row dirty flag; speculated rows are copied into a dense
    payload buffer in the same pass.  One launch per default
    (``fused=True``) save, over every bucket.  `fingerprint_words_cmp`
    launches the same kernel over a packed (C, W) matrix, described as
    one leaf of C rows.
  * `fingerprint_words` — K2, the digest alone, for the ``fused=False``
    and ``batched=False`` rungs.  Its launch splits each row's width into
    segments and gives each block R rows (`digest_plan`), so a launch of
    few long rows fills the card.

Each wrapper checks device, dtype (int32 bit patterns), shape and
contiguity and raises on anything else.  A CUDA tensor launches the
kernel on the current stream; a CPU tensor runs the plain version in
ref.py — the only case in which the plain version runs.  There is no
fallback: a build or launch failure raises.

The kernel library is built from the checkout's own source with `nvcc`
for ``sm_90a`` at first use, into ``build/repro_torch/`` at the root of
the checkout, named by the source's hash, and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ref import (DIGEST_WORDS, MASK32, fingerprint_leaves_cmp_ref,
                  fingerprint_words_cmp_ref, fingerprint_words_ref)

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fingerprint.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches per wrapper — incremented only where a kernel launches
launches = {"fingerprint": 0, "fingerprint_cmp": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    return os.path.join(home or "/usr/local/cuda", "bin", "nvcc")


def build_library() -> Tuple[Path, str]:
    """Compile `csrc/fingerprint.cu` unless this source's library exists.
    Returns (library path, the compiler's output — ptxas register and
    shared-memory report — or "" when the library was already built)."""
    src = _SOURCE.read_bytes()
    lib = _BUILD_DIR / f"libfingerprint-{hashlib.sha256(src).hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {_SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library():
    """The built library with both launchers' ctypes signatures set."""
    lib = ctypes.CDLL(str(build_library()[0]))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.leaves_cmp_launch.argtypes = [p, p, p, p, i64, p, p, p, p, p, i64,
                                      i64, i64, ctypes.c_uint32, p]
    lib.fingerprint_launch.argtypes = [p, i64, i64, p, p, ctypes.c_uint32,
                                       ctypes.c_int, i64, i64, p]
    lib.leaves_cmp_launch.restype = ctypes.c_int
    lib.fingerprint_launch.restype = ctypes.c_int
    return lib


#: threads per K2 block (kThreads in csrc/fingerprint.cu)
DIGEST_THREADS = 256
#: blocks one K2 launch aims for: two waves of four resident blocks on
#: each of the H100's 132 SMs
DIGEST_TARGET_BLOCKS = 2 * 4 * 132


def digest_plan(C: int, W: int) -> Tuple[int, int, int]:
    """K2's launch on (C, W) words, C >= 1: (rows per block R, segments
    per row, 16-byte vectors per segment).

    R is the largest power of two up to min(C, 8), or 1 when W % 4 != 0
    (rows then start at different offsets from a 16-byte boundary and
    cannot share weights).  A row's body of up to W // 4 vectors is cut
    into segments of whole steps (DIGEST_THREADS * U vectors, U = 4 loads
    per thread for R <= 4 and 2 for R = 8) until ceil(C / R) row groups
    times the segments reach DIGEST_TARGET_BLOCKS; a launch with that
    many row groups already is not cut.  The grid is ceil(C / R) *
    segments blocks, at most max(ceil(C / R), 2 * DIGEST_TARGET_BLOCKS)."""
    R = 1 if W % 4 else 1 << (min(C, 8).bit_length() - 1)
    step = DIGEST_THREADS * (4 if R <= 4 else 2)
    nvec = W // 4
    n_seg = max(1, min(-(-DIGEST_TARGET_BLOCKS // -(-C // R)), nvec // step))
    seg_vecs = step * max(1, -(-nvec // (n_seg * step)))
    return R, max(1, -(-nvec // seg_vecs)), seg_vecs


def _check(words: torch.Tensor, lengths: torch.Tensor,
           prev: Optional[torch.Tensor] = None) -> None:
    if words.dtype != torch.int32 or words.dim() != 2:
        raise TypeError(f"words must be an int32 (C, W) tensor, got "
                        f"{words.dtype} of shape {tuple(words.shape)}")
    C = words.shape[0]
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (C,):
        raise TypeError(f"lengths must be an int32 ({C},) tensor, got "
                        f"{lengths.dtype} of shape {tuple(lengths.shape)}")
    tensors = [words, lengths]
    if prev is not None:
        if prev.dtype != torch.int32 or tuple(prev.shape) != (C, DIGEST_WORDS):
            raise TypeError(f"prev must be an int32 ({C}, {DIGEST_WORDS}) "
                            f"tensor, got {prev.dtype} of shape "
                            f"{tuple(prev.shape)}")
        tensors.append(prev)
    for t in tensors:
        if t.device != words.device:
            raise ValueError(f"tensors on {t.device} and {words.device}")
        if not t.is_contiguous():
            raise ValueError("fingerprint kernels take contiguous tensors")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fingerprint kernel for device {words.device}")


def _raise_on(err: int, name: str, words: torch.Tensor) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} at "
                           f"(C, W) = {tuple(words.shape)}")


def fingerprint_words(words: torch.Tensor, lengths: torch.Tensor, *,
                      seed: int = 0) -> torch.Tensor:
    """Digest int32 words (C, W) with true byte lengths (C,) -> int32
    (C, 4), on the device of `words`."""
    _check(words, lengths)
    if words.device.type == "cpu":
        return fingerprint_words_ref(words, lengths, seed=seed)
    C, W = words.shape
    out = torch.empty((C, DIGEST_WORDS), dtype=torch.int32,
                      device=words.device)
    if C:
        R, n_seg, seg_vecs = digest_plan(C, W)
        with torch.cuda.device(words.device):
            stream = torch.cuda.current_stream(words.device).cuda_stream
            err = _library().fingerprint_launch(
                words.data_ptr(), C, W, lengths.data_ptr(), out.data_ptr(),
                seed & MASK32, R, n_seg, seg_vecs, stream)
        _raise_on(err, "fingerprint", words)
        launches["fingerprint"] += 1
    return out


def fingerprint_words_cmp(words: torch.Tensor, lengths: torch.Tensor,
                          prev: torch.Tensor, *, seed: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused digest-and-compare: int32 words (C, W) + previous digests
    (C, 4) -> (digests int32 (C, 4), dirty int32 (C,)).

    dirty[c] == 1 iff digest[c] differs from prev[c] in any lane.  Rows
    whose previous digest is unknown must be forced dirty by the caller.
    On a card this launches K1 over the matrix as one leaf of C rows of W
    whole words, folding the caller's `lengths` (every word is digested,
    whatever `lengths` says, as in the reference).
    """
    _check(words, lengths, prev)
    if words.device.type == "cpu":
        return fingerprint_words_cmp_ref(words, lengths, prev, seed=seed)
    C, W = words.shape
    if not C:
        return (torch.empty((0, DIGEST_WORDS), dtype=torch.int32,
                            device=words.device),
                torch.empty((0,), dtype=torch.int32, device=words.device))
    digs, dirty, _ = _launch_cmp(matrix_table(C, W), [words], prev, None,
                                 seed=seed, lengths=lengths)
    return digs, dirty


# --------------------------------------------------------------------------
# K1 over the leaves in place
# --------------------------------------------------------------------------

#: rows of up to this many whole words take K1's short-row items (the
#: weights of every position in shared memory, a warp per row); longer
#: rows its long-row items (LONG_ROWS rows x one segment)
SHORT_WORDS = 2048
#: rows per short-row block, at most kShortRows (csrc/fingerprint.cu)
SHORT_ROWS = 64
#: rows per long-row block (kR in csrc/fingerprint.cu)
LONG_ROWS = 4
#: 16-byte vectors one long-row step covers per row: 256 threads x kU = 4
LONG_STEP = DIGEST_THREADS * 4
#: a payload slot that is not set
NO_SLOT = 0xFFFFFFFF
#: fields of a work item (kItemInts)
ITEM_INTS = 8


@dataclasses.dataclass(frozen=True, eq=False)
class RowTable:
    """Where K1 reads each digest row: row c is `nfull[c]` whole words,
    plus a last word of which only `part[c]` (1-3) bytes are valid when
    `part[c]` > 0, starting `word_off[c]` words into leaf `leaf[c]`; its
    digest folds `lengths[c]` (None: the caller gives the lengths as a
    tensor).  Built once per plan and compared by identity, so a cached
    table keeps its uploads."""
    leaf: np.ndarray                   # int64 (N,)
    word_off: np.ndarray               # int64 (N,)
    nfull: np.ndarray                  # int64 (N,)
    part: np.ndarray                   # int64 (N,)
    lengths: Optional[np.ndarray]      # uint32 (N,)

    @property
    def n_rows(self) -> int:
        return int(self.nfull.shape[0])

    @property
    def nwords(self) -> np.ndarray:
        """Words of each row, the partial one included."""
        return self.nfull + (self.part > 0)


@functools.lru_cache(maxsize=64)
def matrix_table(C: int, W: int) -> RowTable:
    """A packed (C, W) word matrix as one leaf of C rows of W words."""
    return RowTable(leaf=np.zeros(C, np.int64),
                    word_off=np.arange(C, dtype=np.int64) * W,
                    nfull=np.full(C, W, np.int64),
                    part=np.zeros(C, np.int64), lengths=None)


def readable_leaf(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when K1 can read its bytes in place (contiguous, from a
    4-byte boundary; a bool tensor as its uint8 view), else a contiguous
    copy of its bytes."""
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    if not t.is_contiguous():
        return t.contiguous()
    if t.data_ptr() % 4:
        return t.clone()
    return t


def _addresses(leaves: Sequence[torch.Tensor]) -> np.ndarray:
    return np.fromiter((t.data_ptr() for t in leaves), np.int64,
                       count=len(leaves))


def leaf_mis(leaves: Sequence[torch.Tensor]) -> np.ndarray:
    """Each readable leaf's word offset past a 16-byte boundary (0-3)."""
    return (_addresses(leaves) >> 2) & 3


def row_heads(table: RowTable, mis: np.ndarray) -> np.ndarray:
    """Whole words of each row before its first 16-byte boundary."""
    if not table.n_rows:
        return np.zeros(0, np.int64)
    return np.minimum((4 - (mis[table.leaf] + table.word_off) % 4) % 4,
                      table.nfull)


def payload_slots(table: RowTable, mis: np.ndarray,
                  rows: Sequence[int]) -> np.ndarray:
    """Payload word offsets of `rows` (distinct row indices), each row
    given its whole word count and starting where its first 16-byte
    boundary lands on one in the payload, so that K1 stores aligned
    vectors: uint32 (N,), NO_SLOT for rows not listed."""
    slots = np.full(table.n_rows, NO_SLOT, np.uint32)
    rows = np.asarray(rows, np.int64)
    if rows.size:
        size = (table.nwords[rows] + 3 + 3) // 4 * 4
        base = np.concatenate([[0], np.cumsum(size)[:-1]])
        off = base + (4 - row_heads(table, mis)[rows]) % 4
        if off[-1] + table.nwords[rows[-1]] >= NO_SLOT:
            raise ValueError("payload of more than 2^32 - 1 words")
        slots[rows] = off
    return slots


@functools.lru_cache(maxsize=64)
def inplace_plan(table: RowTable, mis_key: bytes):
    """K1's grid for `table` when leaf l's bytes start mis[l] words past a
    16-byte boundary (`mis_key` = mis as int64 bytes): (row indices in
    group order, int32 (n_items, ITEM_INTS) work items, arrival counters,
    shared-memory bytes).  Rows of equal whole-word count and head form a
    group; long groups are cut into LONG_ROWS-row chunks x segments of
    whole steps (so that the long items reach DIGEST_TARGET_BLOCKS),
    short groups into SHORT_ROWS-row items; long items come first."""
    mis = np.frombuffer(mis_key, np.int64)
    N = table.n_rows
    head = row_heads(table, mis)
    nfull = table.nfull
    order = np.lexsort((np.arange(N), head, -nfull))
    keys = np.stack([nfull[order], head[order]], axis=1)
    cuts = np.flatnonzero((keys[1:] != keys[:-1]).any(axis=1)) + 1
    groups = np.split(order, cuts) if N else []
    long_chunks = sum(-(-len(g) // LONG_ROWS) for g in groups
                      if nfull[g[0]] > SHORT_WORDS)
    items: List[Tuple[int, ...]] = []
    n_arrivals = 0
    smem = 0
    pos = 0
    for g in groups:
        nf, h = int(nfull[g[0]]), int(head[g[0]])
        if nf > SHORT_WORDS:
            nvec = (nf - h) // 4
            n_seg = max(1, min(-(-DIGEST_TARGET_BLOCKS // long_chunks),
                               nvec // LONG_STEP))
            seg_vecs = LONG_STEP * max(1, -(-nvec // (n_seg * LONG_STEP)))
            n_seg = max(1, -(-nvec // seg_vecs))
            for r0 in range(0, len(g), LONG_ROWS):
                count = min(LONG_ROWS, len(g) - r0)
                counter = n_arrivals if n_seg > 1 else 0
                n_arrivals += n_seg > 1
                items += [(pos + r0, count, s, n_seg, seg_vecs, counter, 0, 0)
                          for s in range(n_seg)]
        else:
            tl = 4 + (nf + 1 + 3) // 4 * 4
            smem = max(smem, tl * DIGEST_WORDS * 4)
            items += [(pos + r0, min(SHORT_ROWS, len(g) - r0), -1, 1, 0, 0,
                       tl, 0) for r0 in range(0, len(g), SHORT_ROWS)]
        pos += len(g)
    grows = np.concatenate(groups) if groups else np.zeros(0, np.int64)
    return (grows.astype(np.int32),
            np.asarray(items, np.int32).reshape(-1, ITEM_INTS),
            n_arrivals, smem)


@dataclasses.dataclass(frozen=True)
class _DevicePlan:
    buf: torch.Tensor       # int32: rows (N, 4), grows, items, [lengths]
    grows: int              # element offsets into buf
    items: int
    lengths: int            # -1: none
    n_items: int
    n_arrivals: int
    smem: int


@functools.lru_cache(maxsize=64)
def _device_plan(table: RowTable, mis_key: bytes,
                 device: torch.device) -> _DevicePlan:
    """The row table and `inplace_plan` on `device`, one upload."""
    from .ops import to_device
    grows, items, n_arrivals, smem = inplace_plan(table, mis_key)
    if table.n_rows and (int(table.nfull.max()) >= 1 << 30
                         or int(table.leaf.max()) >= 1 << 31):
        raise ValueError("K1 rows hold fewer than 2^30 words and leaves "
                         "number fewer than 2^31")
    rows = np.empty((table.n_rows, 4), np.int64)
    rows[:, 0] = table.word_off & MASK32
    rows[:, 1] = table.word_off >> 32
    rows[:, 2] = table.leaf
    rows[:, 3] = table.nfull | (table.part << 30)
    parts = [(rows & MASK32).astype(np.uint32).view(np.int32).reshape(-1),
             grows, items.reshape(-1)]
    if table.lengths is not None:
        parts.append(table.lengths.astype(np.uint32).view(np.int32))
    offs = np.cumsum([0] + [p.size for p in parts])
    buf = to_device(np.concatenate(parts).astype(np.int32), device)
    return _DevicePlan(buf=buf, grows=int(offs[1]), items=int(offs[2]),
                       lengths=int(offs[3]) if table.lengths is not None
                       else -1, n_items=items.shape[0],
                       n_arrivals=n_arrivals, smem=smem)


@functools.lru_cache(maxsize=64)
def _extents(table: RowTable) -> np.ndarray:
    """Bytes each leaf must hold for the rows `table` reads from it."""
    ext = np.zeros(int(table.leaf.max()) + 1 if table.n_rows else 0,
                   np.int64)
    np.maximum.at(ext, table.leaf,
                  table.word_off * 4 + table.nfull * 4 + table.part)
    return ext


def _launch_cmp(table: RowTable, leaves: Sequence[torch.Tensor],
                prev: torch.Tensor, spec_slots: Optional[np.ndarray], *,
                seed: int, lengths: Optional[torch.Tensor] = None):
    """Launch K1 over readable `leaves` (on prev's CUDA device)."""
    from .ops import to_device
    device = prev.device
    N = table.n_rows
    ext = _extents(table)
    nbytes = np.fromiter((t.numel() * t.element_size() for t in leaves),
                         np.int64, count=len(leaves))
    if ext.size > len(leaves) or (nbytes[:ext.size] < ext).any():
        raise ValueError("the row table reads past the end of a leaf")
    addresses = _addresses(leaves)
    mis = (addresses >> 2) & 3
    plan = _device_plan(table, mis.tobytes(), device)
    per_call = [addresses.view(np.int32)]
    payload = None
    if spec_slots is not None:
        spec = np.flatnonzero(spec_slots != NO_SLOT)
        if spec.size:
            start = spec_slots[spec].astype(np.int64)
            if ((start + row_heads(table, mis)[spec]) % 4).any():
                raise ValueError("payload slots must put each row's first "
                                 "16-byte boundary on one (payload_slots)")
            n = int((start + table.nwords[spec]).max())
            payload = torch.empty((n,), dtype=torch.int32, device=device)
            per_call.append(spec_slots.view(np.int32))
    if payload is None:
        payload = torch.empty((0,), dtype=torch.int32, device=device)
    up = to_device(np.concatenate(per_call), device)
    ws = torch.empty((N * 5 + plan.n_arrivals,), dtype=torch.int32,
                     device=device)
    base = plan.buf.data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().leaves_cmp_launch(
            up.data_ptr(), base, base + 4 * plan.grows,
            base + 4 * plan.items, plan.n_items,
            lengths.data_ptr() if lengths is not None
            else base + 4 * plan.lengths,
            prev.data_ptr(),
            up.data_ptr() + 8 * len(leaves) if payload.numel() else None,
            payload.data_ptr() if payload.numel() else None,
            ws.data_ptr(), N, plan.n_arrivals, plan.smem, seed & MASK32,
            stream)
    if err != 0:
        raise RuntimeError(f"fingerprint_cmp launch failed: CUDA error {err} "
                           f"over {N} rows of {len(leaves)} leaves")
    launches["fingerprint_cmp"] += 1
    return ws[:N * DIGEST_WORDS].view(N, DIGEST_WORDS), \
        ws[N * DIGEST_WORDS:N * (DIGEST_WORDS + 1)], payload


def fingerprint_leaves_cmp(leaves: Sequence[torch.Tensor], table: RowTable,
                           prev: torch.Tensor,
                           spec_slots: Optional[np.ndarray] = None, *,
                           seed: int = 0):
    """K1: digest every row of `table` where it lies in `leaves`, compare
    with `prev` (int32 (N, 4)) and copy the rows whose `spec_slots` entry
    is set (`payload_slots`) into a payload buffer at that word offset.

    Returns (digests int32 (N, 4), dirty int32 (N,), payload int32): row
    c's bytes are payload words [slot, slot + nwords[c]) (the last one
    masked to its valid bytes); words between rows are undefined.  The
    leaves must lie on prev's device: CUDA tensors launch the kernel on
    the current stream, CPU tensors run the plain version."""
    if table.lengths is None:
        raise ValueError("fingerprint_leaves_cmp needs a table with lengths")
    N = table.n_rows
    if prev.dtype != torch.int32 or tuple(prev.shape) != (N, DIGEST_WORDS) \
            or not prev.is_contiguous():
        raise TypeError(f"prev must be a contiguous int32 ({N}, "
                        f"{DIGEST_WORDS}) tensor, got {prev.dtype} of shape "
                        f"{tuple(prev.shape)}")
    for t in leaves:
        if t.device != prev.device:
            raise ValueError(f"leaf on {t.device}, prev on {prev.device}")
    if spec_slots is not None and spec_slots.shape != (N,):
        raise TypeError(f"spec_slots must have shape ({N},)")
    leaves = [readable_leaf(t) for t in leaves]
    if prev.device.type == "cpu":
        return fingerprint_leaves_cmp_ref(leaves, table, prev, spec_slots,
                                          seed=seed)
    if prev.device.type != "cuda":
        raise ValueError(f"no fingerprint kernel for device {prev.device}")
    if not N:
        return (prev.new_empty((0, DIGEST_WORDS)), prev.new_empty((0,)),
                prev.new_empty((0,)))
    return _launch_cmp(table, leaves, prev, spec_slots, seed=seed)
