"""Chunk fingerprint digest: the spec and its plain versions.

Digest spec (all arithmetic uint32, wrap-around mod 2^32):

    weight_j(i) = mix32(i * A_j + seed + j * 0x632BE59B)
    sum_j(c)    = Σ_i words[c, i] * weight_j(i)
    digest[c,j] = sum_j(c) + mix32(lengths[c] ^ ((j+1) * 0x9E3779B9)) + seed

where mix32 is the xorshift-multiply avalanche

    z ^= z >> 16;  z *= 0x7FEB352D;  z ^= z >> 15;  z *= 0x846CA68B;  z ^= z >> 16

and A_j are four odd xxhash-style primes.  The per-word contribution is a
weighted sum, so any tiling or reduction order gives the same bits; zero
padding contributes nothing, and true byte lengths are folded in
separately to tell trailing-zero content from padding.

Tensors carry uint32 values as ``torch.int32`` bit patterns (a digest
crosses to numpy as ``.numpy().view(np.uint32)``).  torch on the CPU has
no uint32 add, shift or sum, so the plain versions here compute in int64
and mask to 32 bits after every step.  A product of two values below
2^32 overflows int64, so every 32x32-bit multiply splits one factor into
16-bit halves (`_mul32`); each masked product is below 2^32, and a row
sum of up to 2^31 of them fits int64.

The plain torch versions are what the kernel wrappers in fingerprint.py
run for CPU tensors; the numpy twin digests host (numpy) state.  All of
them and the CUDA kernel must agree bit for bit (zero tolerance).
"""
from __future__ import annotations

import numpy as np
import torch

#: four odd 32-bit multipliers (xxhash/murmur lineage)
LANE_PRIMES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
PHI32 = 0x9E3779B9
STREAM_SALT = 0x632BE59B
DIGEST_WORDS = 4

MASK32 = 0xFFFFFFFF
#: int64 elements one row block of the plain digest holds at once; bounds
#: its temporaries on wide buckets (about 8 x 128 MiB at 2^24 elements)
_REF_BLOCK_ELEMS = 1 << 24


def _mul32(a: torch.Tensor, k) -> torch.Tensor:
    """(a * k) mod 2^32 for int64 `a` and `k` (int or int64 tensor), both
    in [0, 2^32), without an int64 overflow: k = hi * 2^16 + lo."""
    lo = k & 0xFFFF
    hi = k >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def mix32(z: torch.Tensor) -> torch.Tensor:
    """xorshift-multiply avalanche on int64 values in [0, 2^32)."""
    z = z ^ (z >> 16)
    z = _mul32(z, 0x7FEB352D)
    z = z ^ (z >> 15)
    z = _mul32(z, 0x846CA68B)
    z = z ^ (z >> 16)
    return z


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any integer tensor) -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def from_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def lane_weights(W: int, seed: int, device) -> torch.Tensor:
    """(DIGEST_WORDS, W) int64 weights weight_j(i) for word positions i."""
    i = torch.arange(W, dtype=torch.int64, device=device)
    return torch.stack([
        mix32((_mul32(i, LANE_PRIMES[j]) + (seed & MASK32)
               + ((j * STREAM_SALT) & MASK32)) & MASK32)
        for j in range(DIGEST_WORDS)])


def length_folds(lengths: torch.Tensor, seed: int) -> torch.Tensor:
    """(C, DIGEST_WORDS) int64: mix32(len ^ (j+1)*PHI) + seed, mod 2^32."""
    ln = to_u32(lengths)
    return torch.stack([
        (mix32(ln ^ (((j + 1) * PHI32) & MASK32)) + (seed & MASK32)) & MASK32
        for j in range(DIGEST_WORDS)], dim=1)


def fingerprint_words_ref(words: torch.Tensor, lengths: torch.Tensor,
                          seed: int = 0) -> torch.Tensor:
    """Plain digest.  words: int32 (C, W); lengths: int32 (C,).
    Returns int32 (C, 4), on the device of `words`."""
    C, W = words.shape
    weights = lane_weights(W, seed, words.device)          # (4, W)
    sums = torch.empty((C, DIGEST_WORDS), dtype=torch.int64,
                       device=words.device)
    step = max(1, _REF_BLOCK_ELEMS // max(W, 1))
    for r0 in range(0, C, step):
        x = to_u32(words[r0:r0 + step])                    # (rows, W)
        for j in range(DIGEST_WORDS):
            sums[r0:r0 + step, j] = _mul32(x, weights[j]).sum(dim=1)
    return from_u32((sums + length_folds(lengths, seed)) & MASK32)


def fingerprint_words_cmp_ref(words: torch.Tensor, lengths: torch.Tensor,
                              prev: torch.Tensor, seed: int = 0):
    """Plain fused digest-and-compare: the digest above plus an int32
    dirty flag per row, 1 iff any digest lane differs from `prev`
    (int32 (C, 4)).  Rows without a trustworthy previous digest must be
    forced dirty by the caller; the compare is sentinel-agnostic."""
    dig = fingerprint_words_ref(words, lengths, seed=seed)
    dirty = (dig != prev).any(dim=1).to(torch.int32)
    return dig, dirty


def _row_words(flat: torch.Tensor, off: int, nfull: int,
               part: int) -> torch.Tensor:
    """One row read in place: `nfull` whole words and `part` valid bytes
    of one more word, from word `off` of a leaf's bytes `flat` (uint8),
    zero above the valid bytes.  int32 (nwords,)."""
    b = flat[off * 4:off * 4 + nfull * 4 + part]
    if part:
        b = torch.cat([b, b.new_zeros(4 - part)])
    return b.view(torch.int32)


def fingerprint_leaves_cmp_ref(leaves, table, prev: torch.Tensor,
                               spec_slots=None, seed: int = 0):
    """Plain fused digest-and-compare over leaves read in place through a
    row table (`fingerprint.RowTable`): row c is `table.nfull[c]` whole
    words and `table.part[c]` valid bytes of one more, from word
    `table.word_off[c]` of leaf `table.leaf[c]`; its digest folds
    `table.lengths[c]`.  `leaves` are contiguous tensors whose bytes start
    on a 4-byte boundary (`fingerprint.readable_leaf`).  Returns
    (digests int32 (N, 4), dirty int32 (N,), payload int32), the payload
    holding the words of each row whose `spec_slots` entry (uint32 word
    offset, 0xFFFFFFFF for none) is set, at that offset, and zeros
    elsewhere."""
    device = prev.device
    N = table.n_rows
    flats = [t.reshape(-1).view(torch.uint8) for t in leaves]
    nwords = table.nwords
    lengths = torch.from_numpy(table.lengths.astype(np.uint32)
                               .view(np.int32)).to(device)
    dig = torch.empty((N, DIGEST_WORDS), dtype=torch.int32, device=device)
    payload = None
    if spec_slots is not None:
        spec = np.flatnonzero(spec_slots != MASK32)
        n = int((spec_slots[spec].astype(np.int64) + nwords[spec]).max()) \
            if spec.size else 0
        payload = torch.zeros((n,), dtype=torch.int32, device=device)
    for w in np.unique(nwords):
        rows = np.flatnonzero(nwords == w)
        step = max(1, _REF_BLOCK_ELEMS // max(int(w), 1))
        for r0 in range(0, rows.size, step):
            batch = rows[r0:r0 + step]
            words = [_row_words(flats[table.leaf[c]], int(table.word_off[c]),
                                int(table.nfull[c]), int(table.part[c]))
                     for c in batch]
            mat = (torch.stack(words) if w else
                   torch.zeros((batch.size, 0), dtype=torch.int32,
                               device=device))
            idx = torch.from_numpy(batch).to(device)
            dig[idx] = fingerprint_words_ref(mat, lengths[idx], seed=seed)
            if payload is not None:
                for c, row in zip(batch, words):
                    slot = int(spec_slots[c])
                    if slot != MASK32:
                        payload[slot:slot + row.numel()] = row
    dirty = (dig != prev).any(dim=1).to(torch.int32)
    if payload is None:
        payload = torch.zeros((0,), dtype=torch.int32, device=device)
    return dig, dirty, payload


# --------------------------------------------------------------------------
# numpy twin (host-side state)
# --------------------------------------------------------------------------

def mix32_np(z: np.ndarray) -> np.ndarray:
    z = np.asarray(z, np.uint32)
    z = z ^ (z >> np.uint32(16))
    z = (z * np.uint32(0x7FEB352D)).astype(np.uint32)
    z = z ^ (z >> np.uint32(15))
    z = (z * np.uint32(0x846CA68B)).astype(np.uint32)
    z = z ^ (z >> np.uint32(16))
    return z


def fingerprint_words_np(words: np.ndarray, lengths: np.ndarray,
                         seed: int = 0) -> np.ndarray:
    """Bit-identical numpy implementation (host-side state hashing)."""
    words = np.asarray(words, np.uint32)
    C, W = words.shape
    i = np.arange(W, dtype=np.uint32)
    out = np.zeros((C, DIGEST_WORDS), dtype=np.uint32)
    with np.errstate(over="ignore"):
        for j in range(DIGEST_WORDS):
            w = mix32_np((i * np.uint32(LANE_PRIMES[j])).astype(np.uint32)
                         + np.uint32(seed) + np.uint32((j * STREAM_SALT) & 0xFFFFFFFF))
            s = (words * w[None, :]).astype(np.uint32).sum(axis=1, dtype=np.uint32)
            fold = mix32_np(np.asarray(lengths, np.uint32)
                            ^ np.uint32(((j + 1) * PHI32) & 0xFFFFFFFF))
            out[:, j] = (s + fold + np.uint32(seed)).astype(np.uint32)
    return out
