"""Chunk fingerprint digest on the GPU: wrappers around the Hopper kernels.

The digest (ref.py) is computed on the device, so only 16 bytes per
chunk, a dirty flag and the speculated dirty rows ever cross to the host
(the single-sync save contract, see batch.py).  Two kernels, one CUDA
source (`csrc/fingerprint.cu`):

  * `fingerprint_words_cmp` — K1, fused digest-and-compare: digests every
    row and compares it with the previous save's digest row on the
    device, emitting a per-row dirty flag.  Runs once per bucket on every
    default (``fused=True``) save.  One block per row.
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
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

from .ref import (DIGEST_WORDS, MASK32, fingerprint_words_cmp_ref,
                  fingerprint_words_ref)

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
    lib.fingerprint_cmp_launch.argtypes = [p, i64, i64, p, p, p, p,
                                           ctypes.c_uint32, p]
    lib.fingerprint_launch.argtypes = [p, i64, i64, p, p, ctypes.c_uint32,
                                       ctypes.c_int, i64, i64, p]
    lib.fingerprint_cmp_launch.restype = ctypes.c_int
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
    """
    _check(words, lengths, prev)
    if words.device.type == "cpu":
        return fingerprint_words_cmp_ref(words, lengths, prev, seed=seed)
    C = words.shape[0]
    out = torch.empty((C, DIGEST_WORDS), dtype=torch.int32,
                      device=words.device)
    dirty = torch.empty((C,), dtype=torch.int32, device=words.device)
    if C:
        with torch.cuda.device(words.device):
            stream = torch.cuda.current_stream(words.device).cuda_stream
            err = _library().fingerprint_cmp_launch(
                words.data_ptr(), C, words.shape[1], lengths.data_ptr(),
                prev.data_ptr(), out.data_ptr(), dirty.data_ptr(),
                seed & MASK32, stream)
        _raise_on(err, "fingerprint_cmp", words)
        launches["fingerprint_cmp"] += 1
    return out, dirty
