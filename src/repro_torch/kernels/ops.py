"""Word streams, per-leaf digests and the one device->host fetch.

`leaf_fingerprint` converts a tensor of any dtype into the canonical
uint32 word stream, splits it on the ObjectGraph's deterministic chunk
grid, and returns one 128-bit digest per chunk.  `tree_fingerprint` maps
the graph of a state tree to a {chunk key -> digest bytes} table.  These
per-leaf functions are the parity oracle; the save hot path runs the
batched engine in `batch.py`, whose layout and single-sync contract are
described there.

Host/device rule: a `torch.Tensor` takes the device path (the tensor's
own device; on the CPU the kernels' plain versions run); an
`np.ndarray` or numpy scalar takes the numpy twin and never syncs.

Every device->host copy of a save goes through `fetch_to_host`: it packs
the tensors into one device buffer, makes one non-blocking copy into
pinned host memory and waits for it once.  `fetch_count` counts those
waits — the save's blocking-sync metric (``n_syncs`` in the stats).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import ObjectGraph, chunk_grid, itemsize_of
from .fingerprint import fingerprint_words
from .ref import fingerprint_words_np

#: blocking device->host copies made by `fetch_to_host`
fetch_count = 0


def is_host_array(arr: Any) -> bool:
    """True for state that digests on the host (numpy arrays and
    scalars); False for tensors, which take the device path."""
    if isinstance(arr, (np.ndarray, np.generic)):
        return True
    if isinstance(arr, torch.Tensor):
        return False
    raise TypeError(f"unsupported array leaf of type {type(arr).__name__}")


def resolve_device(device: Any) -> torch.device:
    """`device` as a torch.device with an explicit index for CUDA, so
    that it compares equal to the `.device` of tensors placed on it."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def fetch_to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Copy tensors (all on one device) to the host with ONE blocking
    wait.  Returns one flat uint8 numpy array of raw bytes per tensor,
    in order (views of one host buffer)."""
    global fetch_count
    device = tensors[0].device
    flat = []
    for t in tensors:
        if t.device != device:
            raise ValueError(f"fetch of tensors on {t.device} and {device}")
        flat.append(t.contiguous().reshape(-1).view(torch.uint8))
    packed = torch.cat(flat)
    if device.type == "cuda":
        host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()
    else:
        host = packed
    fetch_count += 1
    buf = host.numpy()
    out = []
    off = 0
    for f in flat:
        out.append(buf[off:off + f.numel()])
        off += f.numel()
    return out


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a host array without a blocking sync: on a GPU, one
    non-blocking copy from pinned memory (PyTorch's pinned allocator keeps
    the host block alive until the copy completes)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_words(arr: torch.Tensor) -> torch.Tensor:
    """Bitcast a tensor of any dtype to a flat int32 word stream holding
    its little-endian bytes (the reference's uint32 words, as bit
    patterns).  Trailing bytes are zero-padded (the digest folds true
    lengths separately).  A view whose bytes start off a 4-byte boundary
    (a 1-byte or 2-byte slice such as ``t[1:]``) is copied, since int32
    words cannot view it."""
    if arr.dtype == torch.bool:
        arr = arr.to(torch.uint8)
    b = arr.contiguous().reshape(-1).view(torch.uint8)
    pad = (-b.numel()) % 4
    if pad or b.storage_offset() % 4:
        b = torch.cat([b, b.new_zeros(pad)])
    return b.view(torch.int32)


def to_words_np(arr: np.ndarray) -> np.ndarray:
    """Host (numpy) twin of to_words — bit-identical, as uint32."""
    a = np.asarray(arr)
    if a.dtype == np.bool_:
        a = a.astype(np.uint8)
    raw = a.tobytes()
    pad = (-len(raw)) % 4
    if pad:
        raw += b"\0" * pad
    return np.frombuffer(raw, dtype="<u4").copy()


def _chunk_lengths(n_chunks: int, elems: int, itemsize: int,
                   nbytes: int) -> np.ndarray:
    lens = np.full((n_chunks,), elems * itemsize, dtype=np.uint32)
    lens[-1] = nbytes - (n_chunks - 1) * elems * itemsize
    return lens


def leaf_words(arr: torch.Tensor, *, chunk_bytes: int = 1 << 22
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tensor on its flat-range chunk grid, as the digest kernel's
    inputs: int32 words (n_chunks, words per chunk), zero-padded, and the
    chunks' true byte lengths (n_chunks,), both on the tensor's device."""
    shape = tuple(int(d) for d in arr.shape)
    itemsize = itemsize_of(arr.dtype)
    elems, n_chunks = chunk_grid(shape, arr.dtype, chunk_bytes)
    nbytes = arr.numel() * itemsize
    words = to_words(arr)
    wpc = max(1, -(-(elems * itemsize) // 4))
    if n_chunks == 1:
        words = words[None, :]
    else:
        need = n_chunks * wpc
        if words.numel() != need:
            words = torch.cat([words, words.new_zeros(need - words.numel())])
        words = words.reshape(n_chunks, wpc)
    lengths = to_device(
        _chunk_lengths(n_chunks, elems, itemsize, nbytes).view(np.int32),
        arr.device)
    return words.contiguous(), lengths


def leaf_fingerprint(arr: torch.Tensor, *, chunk_bytes: int = 1 << 22,
                     seed: int = 0) -> np.ndarray:
    """Digest one tensor on its flat-range chunk grid -> uint32
    (n_chunks, 4).  Costs one `fetch_to_host`."""
    words, lengths = leaf_words(arr, chunk_bytes=chunk_bytes)
    dig = fingerprint_words(words, lengths, seed=seed)
    return fetch_to_host([dig])[0].view(np.uint32).reshape(-1, 4)


def leaf_fingerprint_np(arr: np.ndarray, *, chunk_bytes: int = 1 << 22,
                        seed: int = 0) -> np.ndarray:
    """Pure-host twin for numpy state (data-pipeline cursors etc.)."""
    a = np.asarray(arr)
    shape = a.shape
    dtype = a.dtype
    elems, n_chunks = chunk_grid(shape, dtype, chunk_bytes)
    total = int(np.prod(shape, dtype=np.int64)) if shape else 1
    nbytes = int(a.nbytes)
    if n_chunks == 1:
        words = to_words_np(a)[None, :]
        lengths = np.asarray([nbytes], np.uint32)
    else:
        flat = a.reshape(-1)
        pad = n_chunks * elems - total
        if pad:
            flat = np.pad(flat, (0, pad))
        words = to_words_np(flat)
        words = words.reshape(n_chunks, words.shape[0] // n_chunks)
        lengths = _chunk_lengths(n_chunks, elems, dtype.itemsize, nbytes)
    return fingerprint_words_np(words, lengths, seed=seed)


def digest_to_bytes(row: np.ndarray) -> bytes:
    return np.asarray(row, np.uint32).tobytes()


def tree_fingerprint(graph: ObjectGraph, *, active_leaf_paths=None,
                     chunk_bytes: int = 1 << 22, seed: int = 0
                     ) -> Dict[str, bytes]:
    """Digest every chunk of (active) leaves -> {chunk key: 16-byte digest}."""
    out: Dict[str, bytes] = {}
    for leaf in graph.leaf_nodes():
        lkey = leaf.key
        if active_leaf_paths is not None and lkey not in active_leaf_paths:
            continue
        arr = graph.arrays[lkey]
        if is_host_array(arr):
            dig = leaf_fingerprint_np(arr, chunk_bytes=chunk_bytes, seed=seed)
        else:
            dig = leaf_fingerprint(arr, chunk_bytes=chunk_bytes, seed=seed)
        for ci in range(dig.shape[0]):
            out[f"{lkey}#[{ci}]"] = digest_to_bytes(dig[ci])
    return out
