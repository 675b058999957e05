"""The chunk digest, as Chipmink's specification states it, in NumPy.

A frozen copy of the spec that the program's plain kernels state
(``kernels/ref.py``), so the benchmark can tell whether a committed
digest is the digest of the bytes it stands for without asking the
program.  All arithmetic is uint32, wrapping mod 2^32:

    weight_j(i) = mix32(i * A_j + seed + j * 0x632BE59B)
    digest[c,j] = sum_i words[c, i] * weight_j(i)
                  + mix32(length[c] ^ ((j+1) * 0x9E3779B9)) + seed

A chunk is a flat range of a leaf's elements (`chunk_grid`), read as
little-endian uint32 words, zero-padded to a whole word; `length` is its
true byte count.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

LANE_PRIMES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
PHI32 = 0x9E3779B9
STREAM_SALT = 0x632BE59B
LANES = 4
DIGEST_BYTES = 16


def mix32(z: np.ndarray) -> np.ndarray:
    z = np.asarray(z, np.uint32)
    z = z ^ (z >> np.uint32(16))
    z = (z * np.uint32(0x7FEB352D)).astype(np.uint32)
    z = z ^ (z >> np.uint32(15))
    z = (z * np.uint32(0x846CA68B)).astype(np.uint32)
    return z ^ (z >> np.uint32(16))


def digest_rows(words: np.ndarray, lengths: np.ndarray,
                seed: int = 0) -> np.ndarray:
    """(C, W) uint32 words and (C,) byte lengths -> (C, 4) uint32."""
    words = np.asarray(words, np.uint32)
    C, W = words.shape
    i = np.arange(W, dtype=np.uint32)
    out = np.zeros((C, LANES), dtype=np.uint32)
    s = np.uint32(seed & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        for j in range(LANES):
            w = mix32((i * np.uint32(LANE_PRIMES[j])).astype(np.uint32) + s
                      + np.uint32((j * STREAM_SALT) & 0xFFFFFFFF))
            acc = (words * w[None, :]).astype(np.uint32).sum(
                axis=1, dtype=np.uint32)
            fold = mix32(np.asarray(lengths, np.uint32)
                         ^ np.uint32(((j + 1) * PHI32) & 0xFFFFFFFF))
            out[:, j] = (acc + fold + s).astype(np.uint32)
    return out


def chunk_grid(n_elems: int, itemsize: int,
               chunk_bytes: int) -> Tuple[int, int]:
    """(elements per chunk, chunks) of a leaf of `n_elems` elements of
    `itemsize` bytes: flat ranges of about `chunk_bytes`, each boundary
    on a 4-byte word."""
    if n_elems == 0:
        return 1, 1
    elems = max(1, chunk_bytes // itemsize)
    if elems >= n_elems:
        return n_elems, 1
    if (elems * itemsize) % 4:
        mult = 2 if (itemsize * 2) % 4 == 0 else 4
        elems = max(mult, (elems // mult) * mult)
        if elems >= n_elems:
            return n_elems, 1
    return elems, -(-n_elems // elems)


def chunk_digests(raw: np.ndarray, itemsize: int, chunk_bytes: int,
                  indices: Iterable[int], seed: int = 0) -> Dict[int, bytes]:
    """16-byte digests of chunks `indices` of one leaf whose bytes are
    `raw` (flat uint8, C order)."""
    raw = np.asarray(raw, np.uint8).reshape(-1)
    n_elems = max(1, raw.size // itemsize)
    elems, n_chunks = chunk_grid(n_elems, itemsize, chunk_bytes)
    step = elems * itemsize
    idx = np.asarray(sorted(set(int(c) for c in indices)), np.int64)
    if idx.size and not (0 <= idx[0] and idx[-1] < n_chunks):
        raise IndexError(f"chunks {idx[0]}..{idx[-1]} of {n_chunks}")
    out: Dict[int, bytes] = {}
    full = idx[(idx + 1) * step <= raw.size]
    if full.size and step % 4 == 0:
        rows = raw[:n_chunks * step if raw.size >= n_chunks * step
                   else (raw.size // step) * step].reshape(-1, step)
        digs = digest_rows(rows[full].view("<u4"),
                           np.full(full.size, step, np.uint32), seed)
        out.update({int(c): d.astype("<u4").tobytes()
                    for c, d in zip(full, digs)})
    for ci in (int(c) for c in idx if int(c) not in out):
        out[ci] = digest_bytes(raw[ci * step:min(raw.size, (ci + 1) * step)],
                               seed)
    return out


def n_chunks_of(nbytes: int, itemsize: int, chunk_bytes: int) -> int:
    return chunk_grid(max(1, nbytes // itemsize), itemsize, chunk_bytes)[1]


def chunk_step(nbytes: int, itemsize: int, chunk_bytes: int) -> int:
    """Bytes of every chunk of such a leaf but its last."""
    return chunk_grid(max(1, nbytes // itemsize), itemsize,
                      chunk_bytes)[0] * itemsize


def digest_bytes(piece: np.ndarray, seed: int = 0) -> bytes:
    """16-byte digest of one chunk's bytes (flat uint8)."""
    piece = np.asarray(piece, np.uint8).reshape(-1)
    padded = np.zeros(-(-piece.size // 4) * 4, np.uint8)
    padded[:piece.size] = piece
    return digest_rows(padded.view("<u4")[None, :],
                       np.asarray([piece.size], np.uint32),
                       seed)[0].astype("<u4").tobytes()
