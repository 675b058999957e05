#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one GPU and check it.

    python3 chip_smoke.py [--seed N] [--layers L]

Phases (each raises on failure; the script then exits non-zero):

  0. Print the card's name and power limit, build the fingerprint kernels
     from `src/repro_torch/csrc/` with nvcc and print the build time and
     the ptxas report.
  1. Hold both kernels against their plain PyTorch versions on the card,
     bit-exact, on a sweep of (C, W) shapes (W % 4 != 0, all-0xFFFFFFFF
     words, and views whose rows start 4, 8 or 12 bytes past a 16-byte
     boundary among them) and on every bucket shape the later phases give
     them, at 24 layers and at 2; time K1
     (fused digest-and-compare) and its plain version at phase 2's bucket
     shapes, and K2 in turns with K1 there.
  2. The main path at full width: `Chipmink(MemoryStore(), device="cuda")`
     with all defaults saves a Qwen1.5-0.5B AdamW training state (random
     values from --seed; 4.64 GB on the card at 24 layers): one bootstrap
     save, 4 sparse rounds (the last 256 rows of the embedding in params,
     mu and nu, plus the step counter), one all-clean resave.  Checks the
     single-sync contract of the last sparse round (also under
     `torch.cuda.set_sync_debug_mode("error")`), the clean resave, and that
     the first and last commits load back bit-exact.  One more sparse
     save runs under torch.profiler for the device-time breakdown.
  3. The `fused=False` and `batched=False` rungs at 2 layers give the
     same manifests (minus `stats`) and pods as `fused=True`.  These rungs
     are K2's (the digest alone) path: its inputs of one save of each rung
     (the bucket matrices, and each leaf's chunk rows) are rebuilt from
     the state, held against the plain version bit-exact, and timed per
     save by CUDA events; torch.profiler's kernel records give K2's device
     time per launch and its share of the byte bound for each distinct
     shape, apart from the host's cost of launching it.
  4. A `FileStore` round trip at 2 layers, reopened by a fresh instance.
  5. Async saves at full width: `Chipmink(async_mode=True)` takes a
     bootstrap save and 4 sparse rounds, each `save()` followed at once by
     the next round's in-place update (`add_` or `index_copy_` on the
     embedding rows of params, mu and nu) on the current stream, then one
     `wait()`.  Every commit loads back bit-exact against the values at
     its `save()` call; the caller's `save()` runs under
     `torch.cuda.set_sync_debug_mode("error")` and makes no fetch, the warm
     sparse body makes exactly one.  Prints `save()` and `wait()` times,
     the snapshot's bytes, stalls, peak device memory, and the snapshot
     alone on an idle card (host time, the span of CUDA events around it,
     and the device time of its copies by torch.profiler).
  6. Checkout at full width: save on main, `branch("exp")`, 4 sparse
     rounds, two leaves changed in place after the last save,
     `checkout("main")`.  The changed leaves are found (their chunks
     dirty) and restored from the store; every untouched leaf comes back
     as the live tensor object, store reads scale with the delta, the
     restored state is bit-exact, and the next warm save makes one fetch
     and reuses pods.
  7. Store features at 2 layers: `delta_chains=True` against the
     whole-pod from-scratch oracle (manifests, pods and loads equal); two
     `multi_writer=True` instances saving from two threads on one
     `FileStore` while a third runs `gc()` (TimeIDs unique, no commit
     lost); `refcounts=True` `evict_branch` frees exactly what a full
     mark-and-sweep frees; a torn pod mid-save from `FaultyStore`, then a
     deep fsck on reopen (every surviving commit loads bit-exact).
  8. Numbers: per-save stage times, per-kernel times against their bound.

The line before the last is a JSON object with one entry per kernel; the
last line is the device line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Without a CUDA device, or without the repository's `src/repro_torch`
beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import importlib
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import msgpack
import torch

REPO = Path(__file__).resolve().parent

#: hf:Qwen/Qwen1.5-0.5B, as declared in src/repro/configs/qwen1_5_0_5b.py:
#: 24 layers, d_model 1024, 16 heads of 64 (kv 16), d_ff 2816, vocab
#: 151936, QKV bias, tied embeddings.  The parameter tree follows the
#: reference's `models/transformer.param_defs` (norm scales in float32,
#: the rest in bfloat16); the AdamW state holds float32 mu and nu
#: (`train/optimizer.adamw_init`).
QWEN1_5_0_5B = dict(layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
                    head_dim=64, d_ff=2816, vocab=151936)
SPARSE_ROWS = 256         # embedding rows each sparse round trains

# H100 SXM peaks (NVIDIA's data sheet, dense, no sparsity):
# 3.35 TB/s HBM3 and 67 TFLOP/s float32 outside the tensor cores, which
# is 132 SMs x 128 lanes x 1.98 GHz with a fused multiply-add counted as
# two operations.  The digest's 32-bit integer instructions (multiply,
# multiply-add, shift, logic) issue at best one per lane per clock on
# those 128 lanes: 33.5 T integer instructions/s, its peak.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
#: integer instructions the digest needs: one multiply-add per word and
#: digest lane (4 lanes), plus the lane weights mix32(i*A_d + seed +
#: d*SALT), which depend only on the position i and so are needed once per
#: position and lane, whatever the row count: a multiply-add and mix32's 8
OPS_PER_WORD_LANE = 1
OPS_PER_WEIGHT = 9
LANES = 4

KERNELS = {
    "fingerprint_cmp": dict(
        replaces="src/repro/kernels/fingerprint.py:80",
        source="src/repro_torch/csrc/fingerprint.cu"),
    "fingerprint": dict(
        replaces="src/repro/kernels/fingerprint.py:51",
        source="src/repro_torch/csrc/fingerprint.cu"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# state and traffic
# --------------------------------------------------------------------------

def param_specs(cfg: dict):
    """[(path, shape, dtype)] of the parameter tree, in declaration order."""
    E, V, F = cfg["d_model"], cfg["vocab"], cfg["d_ff"]
    Hq = cfg["n_heads"] * cfg["head_dim"]
    Hkv = cfg["n_kv_heads"] * cfg["head_dim"]
    bf16, f32 = torch.bfloat16, torch.float32
    specs = [(("embed",), (V, E), bf16), (("final_norm", "scale"), (E,), f32)]
    for i in range(cfg["layers"]):
        p = ("layers", str(i))
        specs += [
            (p + ("norm1", "scale"), (E,), f32),
            (p + ("attn", "wq"), (E, Hq), bf16),
            (p + ("attn", "wk"), (E, Hkv), bf16),
            (p + ("attn", "wv"), (E, Hkv), bf16),
            (p + ("attn", "wo"), (Hq, E), bf16),
            (p + ("attn", "bq"), (Hq,), bf16),
            (p + ("attn", "bk"), (Hkv,), bf16),
            (p + ("attn", "bv"), (Hkv,), bf16),
            (p + ("norm2", "scale"), (E,), f32),
            (p + ("ffn", "w_gate"), (E, F), bf16),
            (p + ("ffn", "w_up"), (E, F), bf16),
            (p + ("ffn", "w_down"), (F, E), bf16),
        ]
    return specs


def _put(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make_state(cfg: dict, gen: torch.Generator, device) -> dict:
    """Random AdamW training state; `lm_head` is the same tensor object as
    `embed` (tied embeddings) in params, mu and nu."""
    params, mu, nu = {}, {}, {}
    for path, shape, dtype in param_specs(cfg):
        _put(params, path, (torch.randn(shape, generator=gen, device=device)
                            * 0.02).to(dtype))
        _put(mu, path, torch.randn(shape, generator=gen, device=device) * 1e-3)
        _put(nu, path, torch.rand(shape, generator=gen, device=device) * 1e-6)
    for tree in (params, mu, nu):
        tree["lm_head"] = tree["embed"]
    return {"params": params, "opt": {"mu": mu, "nu": nu}, "step": 0}


def sparse_round(state: dict, gen: torch.Generator, op: str = "add_") -> None:
    """Train the last SPARSE_ROWS embedding rows in place (by `add_` on
    the row slice, or `index_copy_` of the updated rows); bump the step."""
    for tree, scale in ((state["params"], 0.02),
                        (state["opt"]["mu"], 1e-3),
                        (state["opt"]["nu"], 1e-6)):
        emb = tree["embed"]
        upd = (torch.rand((SPARSE_ROWS, emb.shape[1]), generator=gen,
                          device=emb.device) * scale).to(emb.dtype)
        if op == "add_":
            emb[-SPARSE_ROWS:].add_(upd)
        else:
            rows = torch.arange(emb.shape[0] - SPARSE_ROWS, emb.shape[0],
                                device=emb.device)
            emb.index_copy_(0, rows, emb.index_select(0, rows) + upd)
    state["step"] += 1


TREES = (("params",), ("opt", "mu"), ("opt", "nu"))


def subtree(state: dict, path):
    for k in path:
        state = state[k]
    return state


def embeds(state: dict) -> dict:
    """Clones of what a sparse round changes: the three embeddings (on
    the current stream, so ordered before any later in-place update) and
    the step."""
    return {"trees": [subtree(state, p)["embed"].clone() for p in TREES],
            "step": state["step"]}


def expect_state(live: dict, emb: dict) -> dict:
    """The state a commit must hold when only sparse rounds ran since:
    `live`'s tensors, with the embeddings (and their tied lm_head) and the
    step taken from `emb`."""
    out = {"params": dict(live["params"]),
           "opt": {"mu": dict(live["opt"]["mu"]),
                   "nu": dict(live["opt"]["nu"])},
           "step": emb["step"]}
    for path, e in zip(TREES, emb["trees"]):
        tree = subtree(out, path)
        tree["embed"] = tree["lm_head"] = e
    return out


def check_commit(ck, tid: int, want: dict) -> None:
    got = ck.load(time_id=tid)
    bit_equal(got, want)
    for path in TREES:
        if subtree(got, path)["lm_head"] is not subtree(got, path)["embed"]:
            raise AssertionError(f"commit {tid}: tied lm_head is no alias")


def leaf_paths(cfg: dict):
    """Every canonical (non-alias) tensor leaf of the state, as a path."""
    return [t + p for t in TREES for p, _, _ in param_specs(cfg)]


def snapshot(tree, memo=None):
    """A copy of a state on the current stream; tied tensors stay tied."""
    memo = {} if memo is None else memo
    if isinstance(tree, dict):
        return {k: snapshot(v, memo) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        if id(tree) not in memo:
            memo[id(tree)] = tree.clone()
        return memo[id(tree)]
    return tree


def bit_equal(a, b, path="") -> None:
    """Raise unless two trees hold the same keys, scalars and tensor bytes."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)
                and a.keys() == b.keys()):
            raise AssertionError(f"tree mismatch at {path!r}")
        for k in a:
            bit_equal(a[k], b[k], f"{path}/{k}")
        return
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and a.device == b.device
                and torch.equal(a.reshape(-1).view(torch.uint8),
                                b.reshape(-1).view(torch.uint8))):
            raise AssertionError(f"tensor bytes differ at {path!r}")
        return
    if a != b:
        raise AssertionError(f"value differs at {path!r}: {a!r} != {b!r}")


def tensors_of(tree) -> list:
    """The distinct tensors of a state (a tied tensor once)."""
    seen, out = set(), []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    walk(tree)
    return out


def state_bytes(tree) -> int:
    return sum(t.nbytes for t in tensors_of(tree))


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def bucket_shapes(cfg: dict, chunk_bytes: int):
    """(padded_rows, width) of every bucket the main path digests: the
    plan of the state's canonical (non-alias) leaves."""
    from repro_torch.core.graph import dtype_name
    from repro_torch.kernels.batch import plan_leaves
    specs = []
    for tree, slot_dtype in (("params", None), ("opt/mu", torch.float32),
                             ("opt/nu", torch.float32)):
        for path, shape, dtype in param_specs(cfg):
            specs.append(("/".join((tree,) + path), shape,
                          dtype_name(slot_dtype or dtype)))
    return [(b.padded_rows, b.width)
            for b in plan_leaves(tuple(specs), chunk_bytes).buckets]


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


class Bound:
    """Least time on the card for a sum of digests: each input byte read
    once, each output byte written once, over the HBM rate; the integer
    instructions the digest needs over their peak rate; the larger."""

    def __init__(self) -> None:
        self.ops = 0
        self.bytes = 0

    def add(self, C: int, W: int, compare: bool) -> None:
        """One digest of C rows of W words: read words, lengths (and
        prev), write digests (and dirty flags)."""
        self.bytes += (C * W * 4 + C * 4 + C * 16
                       + (C * 16 + C * 4 if compare else 0))
        self.ops += (C * W * LANES * OPS_PER_WORD_LANE
                     + W * LANES * OPS_PER_WEIGHT)

    @property
    def ms(self) -> float:
        return max(self.bytes / HBM_BYTES_PER_S,
                   self.ops / INT32_OPS_PER_S) * 1e3

    @property
    def by(self) -> str:
        return ("operations" if self.ops / INT32_OPS_PER_S
                > self.bytes / HBM_BYTES_PER_S else "bytes")


def max_abs_diff(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not got.numel():
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def phase_kernels(shapes, timed_shapes, gen, device):
    """Both kernels vs their plain versions, bit-exact on `shapes`, each
    (C, W, offset): the words are a view that starts `offset` words into a
    fresh tensor, so its rows start 4 * offset bytes past a 16-byte
    boundary.  K1 and its plain version timed at `timed_shapes` (the main
    path's buckets).  Returns (max abs error per kernel, K1's numbers)."""
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.kernels import ref
    err = {"fingerprint": 0, "fingerprint_cmp": 0}
    k1 = dict(ms=0.0, plain_ms=0.0)
    k2_ms = 0.0                 # K2 at these shapes, for comparison only
    bound = Bound()
    lo, hi = torch.iinfo(torch.int32).min, torch.iinfo(torch.int32).max
    for C, W, offset in shapes:
        words = torch.randint(lo, hi, (C * W + offset,), generator=gen,
                              device=device, dtype=torch.int32)
        words = words[offset:].view(C, W)
        if words.data_ptr() % 16 != 4 * offset:
            raise AssertionError(f"view at offset {offset} is not "
                                 f"{4 * offset} bytes past 16")
        if (C, W) == (3, 4096) and not offset:
            words.fill_(-1)          # all-0xFFFFFFFF: the int64 overflow edge
        lengths = torch.randint(0, 4 * W + 1, (C,), generator=gen,
                                device=device, dtype=torch.int32)
        plain = ref.fingerprint_words_ref(words, lengths, seed=C + W)
        prev = plain.clone()
        flip = torch.rand((C,), generator=gen, device=device) < 0.5
        prev[:, 0] ^= flip.to(torch.int32)
        d2 = fp.fingerprint_words(words, lengths, seed=C + W)
        d1, m1 = fp.fingerprint_words_cmp(words, lengths, prev, seed=C + W)
        pd, pm = ref.fingerprint_words_cmp_ref(words, lengths, prev,
                                               seed=C + W)
        torch.cuda.synchronize()
        where = f"(C, W) = ({C}, {W}), rows {4 * offset} bytes past 16"
        for name, got, want in (("fingerprint", d2, plain),
                                ("fingerprint_cmp", d1, pd),
                                ("fingerprint_cmp", m1, pm)):
            diff = max_abs_diff(got, want)
            err[name] = max(err[name], diff)
            if diff:
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at {where}")
        if not torch.equal(pm, flip.to(torch.int32)):
            raise AssertionError(f"dirty flags wrong at {where}")
        if (C, W) in timed_shapes and not offset:
            iters = max(3, min(200, int(2e9 // max(C * W * 4, 1))))
            runs = (lambda: fp.fingerprint_words_cmp(words, lengths, prev),
                    lambda: fp.fingerprint_words(words, lengths))
            # in turns (K1, K2, K2, K1) so clock ramps hit both alike
            for k in (0, 1, 1, 0):
                t = cuda_ms(runs[k], iters) / 2
                if k == 0:
                    k1["ms"] += t
                else:
                    k2_ms += t
            k1["plain_ms"] += cuda_ms(
                lambda: ref.fingerprint_words_cmp_ref(words, lengths, prev), 2)
            bound.add(C, W, compare=True)
        log(f"[kernels] {where}: K1 and K2 bit-exact with their plain "
            f"versions")
        del words, lengths, plain, prev, d1, d2, m1, pd, pm
    k1.update(bound_ms=bound.ms, bound_by=bound.by)
    log(f"[kernels] at the main path's buckets, in turns: K1 {k1['ms']:.4f} "
        f"ms, K2 (which that path does not run) {k2_ms:.4f} ms, bound "
        f"{bound.ms:.4f} ms")
    return err, k1


def phase_main(cfg: dict, gen: torch.Generator, device) -> dict:
    from repro_torch.core import Chipmink, MemoryStore
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.kernels import ops

    state = make_state(cfg, gen, device)
    torch.cuda.synchronize()
    log(f"[main] state: {cfg['layers']} layers, "
        f"{state_bytes(state) / 1e9:.3f} GB on {device}")
    ck = Chipmink(MemoryStore(), device=device)
    first = snapshot(state)
    walls = []

    def save() -> int:
        t = time.perf_counter()
        tid = ck.save(state)
        walls.append(time.perf_counter() - t)
        return tid

    torch.cuda.reset_peak_memory_stats(device)
    fp.reset_launch_counts()
    t0 = time.perf_counter()
    tids = [save()]
    for r in range(4):
        sparse_round(state, gen)
        last = r == 3
        fetches = ops.fetch_count
        if last:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            tids.append(save())
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if last:
            s = ck.save_stats[-1]
            want = dict(n_digest_syncs=1, n_gather_syncs=0,
                        n_corrective_syncs=0, n_spec_misses=0)
            got = {k: s[k] for k in want}
            if got != want or ops.fetch_count - fetches != 1:
                raise AssertionError(
                    f"warm sparse save is not single-sync: {got}, "
                    f"{ops.fetch_count - fetches} fetches")
    fetches = ops.fetch_count
    tids.append(save())
    s = ck.save_stats[-1]
    if (s["pods_written"] != 0 or s["n_digest_syncs"] != 1
            or ops.fetch_count - fetches != 1):
        raise AssertionError(f"clean resave wrote {s['pods_written']} pods "
                             f"with {ops.fetch_count - fetches} fetches")
    t_saves = time.perf_counter() - t0
    launches = dict(fp.launches)
    peak = torch.cuda.max_memory_allocated(device)
    for tid, want in ((tids[0], first), (tids[-1], state)):
        t0 = time.perf_counter()
        got = ck.load(time_id=tid)
        torch.cuda.synchronize()
        bit_equal(got, want)
        if got["params"]["lm_head"] is not got["params"]["embed"]:
            raise AssertionError("tied lm_head did not load as an alias")
        log(f"[main] load of commit {tid} is bit-exact "
            f"({time.perf_counter() - t0:.3f} s)")
        del got
    del first
    trace_warm_save(ck, state, gen)
    for s, wall in zip(ck.save_stats, walls):
        log("[main] save " + json.dumps(dict(wall_s=wall, **{k: s[k] for k in (
            "time_id", "t_graph", "t_digest", "t_podding", "t_gather",
            "t_write", "bytes_written", "pods_written", "n_dirty_chunks",
            "n_spec_predicted", "n_digest_syncs", "n_gather_syncs")})))
    log(f"[main] {len(tids)} saves in {t_saves:.3f} s; kernel launches "
        f"{launches}; peak device memory {peak / 1e9:.3f} GB")
    return dict(launches=launches, n_saves=len(tids))


def trace_warm_save(ck, state: dict, gen: torch.Generator) -> None:
    """One more sparse round, saved under torch.profiler: the device time
    by kernel and the device's busy share of the save's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sparse_round(state, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ck.save(state)
        wall = time.perf_counter() - t0
    if ck.save_stats[-1]["n_digest_syncs"] != 1:
        raise AssertionError("traced warm save is not single-sync")
    # device-side events only (kernels, memcpy, memset): the aten ops that
    # launched them repeat the same time as their own device time.
    avgs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in avgs)
    log(f"[trace] warm sparse save under the profiler: wall {wall * 1e3:.3f}"
        f" ms, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / 1e3 / (wall * 1e3):.1f}% of wall)")
    top = sorted((e for e in avgs if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        log(f"[trace]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<5d} {e.key[:90]}")


def _stripped(ck, tid) -> bytes:
    """A commit's manifest minus its timing stats and the storage-form
    ``delta_of`` records, packed."""
    m = {k: v for k, v in ck.store.get_manifest(tid).items() if k != "stats"}
    m["pods"] = {pid: {k: v for k, v in meta.items() if k != "delta_of"}
                 for pid, meta in m["pods"].items()}
    return msgpack.packb(m, use_bin_type=True)


def phase_rungs(cfg: dict, gen: torch.Generator, device) -> dict:
    from repro_torch.core import Chipmink, MemoryStore
    from repro_torch.kernels import fingerprint as fp
    state = make_state(cfg, gen, device)
    rungs = {"fused": {}, "two_sync": {"fused": False},
             "per_leaf": {"batched": False}}
    cks = {k: Chipmink(MemoryStore(), device=device, **kw)
           for k, kw in rungs.items()}
    fp.reset_launch_counts()
    per_rung = {k: 0 for k in cks}          # K2 launches per rung
    for r in range(4):
        if r in (1, 2):
            sparse_round(state, gen)
        tids = {}
        for k, ck in cks.items():
            before = fp.launches["fingerprint"]
            tids[k] = ck.save(state)
            per_rung[k] += fp.launches["fingerprint"] - before
        base = _stripped(cks["fused"], tids["fused"])
        for k, ck in cks.items():
            if _stripped(ck, tids[k]) != base:
                raise AssertionError(f"{k} manifest differs at save {r}")
            for meta in ck.store.get_manifest(tids[k])["pods"].values():
                if ck.store.get_pod(meta["d"]) != \
                        cks["fused"].store.get_pod(meta["d"]):
                    raise AssertionError(f"{k} pod {meta['d']} differs")
    launches = dict(fp.launches)
    log(f"[rungs] fused, fused=False and batched=False: identical manifests "
        f"and pods over 4 saves; kernel launches {launches}; fingerprint "
        f"launches per save by rung "
        f"{ {k: n / 4 for k, n in per_rung.items()} }")
    k2 = k2_on_its_inputs(state, per_rung, device)
    return launches, k2


def k2_on_its_inputs(state: dict, per_rung: dict, device) -> dict:
    """Rebuild K2's inputs of one save of each of its rungs from the
    state: the fused=False rung's bucket matrices and the batched=False
    rung's per-leaf chunk rows, packed as those rungs pack them.  Their
    count must equal the launches each rung made per save.  Holds K2
    against the plain version on them bit-exact and times both per save
    (the bucket launches of one rung plus the per-leaf launches of the
    other)."""
    from repro_torch.core.graph import build_graph
    from repro_torch.kernels import batch, ops, ref
    from repro_torch.kernels import fingerprint as fp
    chunk_bytes = 1 << 22
    graph = build_graph(state, chunk_bytes=chunk_bytes)
    items = [(leaf.key, graph.arrays[leaf.key])
             for leaf in graph.leaf_nodes()]
    plan = batch.plan_leaves(batch._specs(items), chunk_bytes)
    arrays = [a for _, a in items]
    inputs = {
        "two_sync": list(zip(batch._pack(plan, arrays, device),
                             batch._plan_lengths_on(plan, device))),
        "per_leaf": [ops.leaf_words(a, chunk_bytes=chunk_bytes)
                     for a in arrays],
    }
    for rung, ins in inputs.items():
        if len(ins) * 4 != per_rung[rung]:
            raise AssertionError(
                f"{rung}: rebuilt {len(ins)} K2 inputs per save, the rung "
                f"launched {per_rung[rung] / 4} per save")
    out = dict(ms=0.0, plain_ms=0.0, max_abs_err=0, not_measured=[])
    bound = Bound()
    for rung, ins in inputs.items():
        rung_bound = Bound()
        for words, lengths in ins:
            diff = max_abs_diff(fp.fingerprint_words(words, lengths),
                                ref.fingerprint_words_ref(words, lengths))
            if diff:
                raise AssertionError(
                    f"fingerprint differs from its plain version on the "
                    f"{rung} rung at {tuple(words.shape)}")
            bound.add(*words.shape, compare=False)
            rung_bound.add(*words.shape, compare=False)
        ms = cuda_ms(lambda: [fp.fingerprint_words(w, n) for w, n in ins], 20)
        plain = cuda_ms(
            lambda: [ref.fingerprint_words_ref(w, n) for w, n in ins], 2)
        out["ms"] += ms
        out["plain_ms"] += plain
        log(f"[rungs] K2 on the {rung} rung's {len(ins)} inputs per save "
            f"{sorted({tuple(w.shape) for w, _ in ins})}: bit-exact with "
            f"the plain version; {ms:.4f} ms per save by CUDA events "
            f"(plain {plain:.4f} ms), bound {rung_bound.ms:.4f} ms "
            f"({100 * rung_bound.ms / ms:.1f}% of it)")
        device_us = 0.0
        times = k2_device_times(ins)
        missing = sorted({tuple(w.shape) for w, _ in ins} - set(times))
        for shape, t in times.items():
            per_launch = t["kernel_us"] + t["memset_us"]
            device_us += t["n"] * per_launch
            one = Bound()
            one.add(*shape, compare=False)
            log(f"[rungs]   {shape} x{t['n']} per save: device "
                f"{per_launch:.3f} us per launch (kernel "
                f"{t['kernel_us']:.3f} + memset {t['memset_us']:.3f}), "
                f"bound {one.ms * 1e3:.3f} us ({one.by}), "
                f"{100 * one.ms * 1e3 / per_launch:.1f}% of it")
        out["not_measured"] += [(rung, shape) for shape in missing]
        if missing:
            log(f"[rungs] K2 on the {rung} rung: device time not measured "
                f"at {missing} (no sound profiling window); "
                f"{device_us / 1e3:.4f} ms per save at the other shapes")
        else:
            log(f"[rungs] K2 on the {rung} rung: device time "
                f"{device_us / 1e3:.4f} ms per save by torch.profiler, bound "
                f"{rung_bound.ms:.4f} ms; the rest of the {ms:.4f} ms is the "
                f"host launching it")
    out.update(bound_ms=bound.ms, bound_by=bound.by)
    return out


def k2_device_times(ins) -> dict:
    """K2's device time per launch for each distinct (C, W) of `ins`, from
    torch.profiler's records of its kernel (`digest_kernel`) and of the
    memset that zeroes the digests of a launch cut into several segments,
    each averaged over one window of back-to-back launches.  A window is
    taken again, up to 3 times, when the profiler lost more than one
    record of it or read a launch as faster than its byte bound, which no
    launch can be; a shape without a sound window is left out (not
    measured): {shape: dict(n=inputs of that shape, kernel_us=,
    memset_us=)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import fingerprint as fp
    by_shape = {}
    for words, lengths in ins:
        by_shape.setdefault(tuple(words.shape), []).append((words, lengths))
    times = {}
    for shape, group in by_shape.items():
        reps = max(3, 24 // len(group))
        n = reps * len(group)
        split = fp.digest_plan(*shape)[1] > 1
        floor = Bound()
        floor.add(*shape, compare=False)
        for attempt in range(1, 4):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    for words, lengths in group:
                        fp.fingerprint_words(words, lengths)
                torch.cuda.synchronize()
            total = {"digest_kernel": 0.0, "Memset": 0.0}
            count = {"digest_kernel": 0, "Memset": 0}
            for e in prof.key_averages():
                for name in total:
                    if e.device_type == DeviceType.CUDA and name in e.key:
                        total[name] += e.self_device_time_total
                        count[name] += e.count
            if not (n - 1 <= count["digest_kernel"] <= n
                    and (n - 1 <= count["Memset"] <= n if split
                         else count["Memset"] == 0)):
                log(f"[rungs]   window {attempt} of 3 at {shape}: the "
                    f"profiler kept {count} records of {n} launches")
                continue
            t = dict(n=len(group),
                     kernel_us=total["digest_kernel"] / count["digest_kernel"],
                     memset_us=total["Memset"] / max(count["Memset"], 1))
            if t["kernel_us"] + t["memset_us"] < floor.ms * 1e3:
                log(f"[rungs]   window {attempt} of 3 at {shape}: the "
                    f"profiler read {t}, below the byte bound")
                continue
            times[shape] = t
            break
    return times


def phase_filestore(cfg: dict, gen: torch.Generator, device) -> None:
    from repro_torch.core import Chipmink, FileStore
    state = make_state(cfg, gen, device)
    with tempfile.TemporaryDirectory() as root:
        ck = Chipmink(FileStore(root), device=device)
        ck.save(state)
        sparse_round(state, gen)
        tid = ck.save(state)
        fresh = Chipmink(FileStore(root), device=device)
        bit_equal(fresh.load(time_id=tid), state)
        if fresh.last_fsck is None or not fresh.last_fsck.clean:
            raise AssertionError("fsck on reopen found damage")
    log("[filestore] save, reopen, load: bit-exact")


class FetchesByThread:
    """Counts the port's blocking device->host copies (`fetch_to_host`)
    per thread while installed, by wrapping the name in each module that
    calls it."""

    MODULES = ("repro_torch.kernels.ops", "repro_torch.kernels.batch",
               "repro_torch.core.podding")

    def __enter__(self) -> "FetchesByThread":
        self.counts = collections.Counter()
        self.saved = [(m, m.fetch_to_host) for m in
                      map(importlib.import_module, self.MODULES)]
        real = self.saved[0][1]

        def counted(tensors):
            self.counts[threading.get_ident()] += 1
            return real(tensors)

        for mod, _ in self.saved:
            mod.fetch_to_host = counted
        return self

    def __exit__(self, *exc) -> None:
        for mod, real in self.saved:
            mod.fetch_to_host = real


def phase_async(cfg: dict, gen: torch.Generator, device) -> dict:
    """Async saves of a state the caller changes in place right after
    each save() returns (see the module docstring, phase 5)."""
    from repro_torch.core import Chipmink, MemoryStore
    from repro_torch.kernels import fingerprint as fp
    state = make_state(cfg, gen, device)
    torch.cuda.synchronize()
    ck = Chipmink(MemoryStore(), device=device, async_mode=True)
    caller = threading.get_ident()
    expected, walls = {}, []
    torch.cuda.reset_peak_memory_stats(device)
    fp.reset_launch_counts()
    with FetchesByThread() as fetches:
        t0 = time.perf_counter()
        for r in range(5):                 # bootstrap, then 4 sparse rounds
            emb = embeds(state)
            torch.cuda.set_sync_debug_mode("error")
            try:
                t = time.perf_counter()
                tid = ck.save(state)
                walls.append(time.perf_counter() - t)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if fetches.counts[caller]:
                raise AssertionError(f"save() of commit {tid} fetched on the "
                                     f"caller's thread")
            expected[tid] = emb
            # the next round at once, in place, on the current stream
            sparse_round(state, gen, "add_" if r % 2 else "index_copy_")
        t = time.perf_counter()
        ck.wait()
        t_wait = time.perf_counter() - t
        t_all = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(fp.launches)
    peak = torch.cuda.max_memory_allocated(device)
    stats = ck.save_stats
    # the fused path's corrective gather is its gather: counted in both
    syncs = [s["n_digest_syncs"] + s["n_gather_syncs"] for s in stats]
    body = sum(n for th, n in fetches.counts.items() if th != caller)
    if body != sum(syncs):
        raise AssertionError(f"bodies fetched {body} times, their stats "
                             f"count {syncs}")
    last = stats[-1]
    if syncs[-1] != 1 or last["n_digest_syncs"] != 1 or last["n_spec_misses"]:
        raise AssertionError(f"warm sparse async body is not single-sync: "
                             f"{syncs}, {last}")
    if launches["fingerprint_cmp"] <= 0:
        raise AssertionError("async saves launched no fingerprint_cmp")
    for s, wall in zip(stats, walls):
        log("[async] save " + json.dumps(dict(
            save_call_s=wall, **{k: s[k] for k in (
                "time_id", "t_graph", "t_snapshot", "n_snapshot_bytes",
                "t_digest", "t_podding", "t_gather", "t_write",
                "pods_written", "n_digest_syncs", "n_gather_syncs",
                "n_corrective_syncs")})))
    log(f"[async] 5 saves: save() calls {sum(walls):.4f} s in all (warm "
        f"{walls[1:]}), wait() {t_wait:.3f} s, loop {t_all:.3f} s; stalls "
        f"{ck.saver.n_stalls}, overlapped {ck.saver.n_overlapped}; snapshot "
        f"{stats[-1]['n_snapshot_bytes'] / 1e9:.3f} GB per save; caller "
        f"fetches 0, "
        f"body fetches {syncs}; peak device memory {peak / 1e9:.3f} GB; "
        f"kernel launches {launches}")
    for tid, emb in expected.items():
        check_commit(ck, tid, expect_state(state, emb))
    log(f"[async] all {len(expected)} commits load bit-exact: the in-place "
        f"update issued after each save() never reached its commit")
    if ck.close():
        raise AssertionError("async close() returned errors")
    alone = time_snapshot_alone(state)
    return dict(launches=launches, walls=walls, t_wait=t_wait, peak=peak,
                n_stalls=ck.saver.n_stalls, alone=alone)


def time_snapshot_alone(state: dict) -> dict:
    """The async save's snapshot of `state` (`ops.snapshot_tensors`) on
    an idle card, 3 times: the host time of the call and the span between
    CUDA events around it; then the device time of its copies alone, by
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    leaves = tensors_of(state)
    host, span = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        views, buf = ops.snapshot_tensors(leaves)
        b.record()
        host.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        span.append(a.elapsed_time(b))
        del views, buf
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        views, buf = ops.snapshot_tensors(leaves)
        torch.cuda.synchronize()
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3
    del views, buf
    log(f"[async] snapshot alone on an idle card, {len(leaves)} tensors, "
        f"{state_bytes(state) / 1e9:.3f} GB: host {host} ms, event span "
        f"{span} ms, device time of its copies {device:.3f} ms "
        f"(profiler; read and write at "
        f"{2 * state_bytes(state) / device / 1e9:.3f} TB/s)")
    return dict(host_ms=host, span_ms=span, device_ms=device)


def phase_checkout(cfg: dict, gen: torch.Generator, device) -> dict:
    """Delta-aware checkout of main after 4 sparse rounds on a branch
    (see the module docstring, phase 6)."""
    from repro_torch.core import Chipmink, MemoryStore
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.kernels import ops
    state = make_state(cfg, gen, device)
    ck = Chipmink(MemoryStore(), device=device)
    ck.save(state)
    main = embeds(state)
    ck.branch("exp")
    for _ in range(4):
        sparse_round(state, gen)
        ck.save(state)
    # changed in place after the last save, as a training step would: the
    # first row of a 3-chunk leaf and a 1-chunk leaf, both untouched on
    # the branch.  Checkout must restore them from the store.
    changed = [("opt", "mu", "layers", "0", "ffn", "w_up"),
               ("params", "final_norm", "scale")]
    kept = [subtree(state, p).clone() for p in changed]
    for p in changed:
        subtree(state, p)[0] += 1.0
    torch.cuda.synchronize()
    r0 = ck.store.stats.read_bytes
    f0 = ops.fetch_count
    t = time.perf_counter()
    out = ck.checkout("main")
    torch.cuda.synchronize()
    t_checkout = time.perf_counter() - t
    read = ck.store.stats.read_bytes - r0
    cs = ck.last_checkout_stats
    if ops.fetch_count - f0 != cs.n_syncs or cs.n_dirty_chunks != 2:
        raise AssertionError(f"checkout fetched {ops.fetch_count - f0} "
                             f"times and found {cs.n_dirty_chunks} changed "
                             f"chunks: {cs}")
    for p, v in zip(changed, kept):
        if subtree(out, p) is subtree(state, p):
            raise AssertionError(f"checkout handed back {'/'.join(p)}, "
                                 f"changed in place since the last save")
        subtree(state, p).copy_(v)      # the live state as it was saved
    untouched = [p for p in leaf_paths(cfg)
                 if p[-1] != "embed" and p not in changed]
    for p in untouched:
        if subtree(out, p) is not subtree(state, p):
            raise AssertionError(f"checkout did not hand back the live "
                                 f"tensor at {'/'.join(p)}")
    if cs.n_leaves_reused != len(untouched):
        raise AssertionError(f"{cs.n_leaves_reused} leaves reused, "
                             f"{len(untouched)} untouched")
    bit_equal(out, expect_state(state, main))
    for path in TREES:
        if subtree(out, path)["lm_head"] is not subtree(out, path)["embed"]:
            raise AssertionError("checked-out lm_head is no alias")
    total = state_bytes(state)
    if read != cs.read_bytes or not 0 < read < 0.05 * total:
        raise AssertionError(f"checkout read {read} bytes (stats "
                             f"{cs.read_bytes}) of a {total}-byte state")
    sparse_round(out, gen)
    fp.reset_launch_counts()
    f0 = ops.fetch_count
    t = time.perf_counter()
    ck.save(out)
    wall = time.perf_counter() - t
    s = ck.save_stats[-1]
    if (ops.fetch_count - f0 != 1 or s["n_digest_syncs"] != 1
            or s["n_pods_reused"] <= 0):
        raise AssertionError(f"save after checkout: {ops.fetch_count - f0} "
                             f"fetches, {s}")
    launches = dict(fp.launches)
    log(f"[checkout] checkout('main') in {t_checkout:.3f} s: "
        f"{cs.n_dirty_chunks} chunks changed in place found with "
        f"{cs.n_syncs} fetch(es); "
        f"{cs.n_leaves_reused} of {len(leaf_paths(cfg))} leaves handed back "
        f"as the live tensors, {cs.n_pods_fetched} of {cs.n_pods} pods read, "
        f"{read / 1e6:.3f} MB read of a {total / 1e9:.3f} GB state; "
        f"bit-exact; the next warm save {wall * 1e3:.3f} ms, 1 fetch, "
        f"{s['n_pods_reused']} pods reused; kernel launches {launches}")
    return dict(launches=launches, t_checkout=t_checkout, read=read,
                n_reused=cs.n_leaves_reused, save_after_ms=wall * 1e3)


def phase_store_features(cfg: dict, gen: torch.Generator, device) -> dict:
    """Delta chains, multi-writer threads with a concurrent gc, refcount
    eviction and a crash mid-save (see the module docstring, phase 7)."""
    from repro_torch.core import (BundleAll, Chipmink, FaultyStore,
                                  FileStore, InjectedCrash, MemoryStore)
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.version import fsck, mark_and_sweep
    fp.reset_launch_counts()
    out = {}

    # -- delta chains against the whole-pod from-scratch oracle ----------
    # One pod holds every chunk (`BundleAll`, as the reference's delta
    # benchmark podds), so a sparse round dirties a few of its entries and
    # the delta form pays; pods of one chunk each never take it.
    t0 = time.perf_counter()
    state = make_state(cfg, gen, device)
    ck = Chipmink(MemoryStore(), BundleAll(), device=device,
                  delta_chains=True)
    oracle = Chipmink(MemoryStore(), BundleAll(), device=device,
                      incremental=False)
    tids = []
    for r in range(3):
        if r:
            sparse_round(state, gen)
        tid = ck.save(state)
        if oracle.save(state) != tid:
            raise AssertionError("delta and oracle TimeIDs differ")
        tids.append(tid)
    for tid in tids:
        if _stripped(ck, tid) != _stripped(oracle, tid):
            raise AssertionError(f"delta manifest {tid} differs")
        m = ck.store.get_manifest(tid)
        for meta in m["pods"].values():
            if ck.store.get_pod(meta["d"]) != oracle.store.get_pod(meta["d"]):
                raise AssertionError(f"pod {meta['d']} differs")
    # the chain's tip replays every link (its pods were compared above)
    bit_equal(ck.load(time_id=tids[-1]), oracle.load(time_id=tids[-1]))
    depth = max(ck.store.pod_chain_depth(meta["d"])
                for meta in m["pods"].values())
    if depth != 2:
        raise AssertionError(f"the last commit's chain is {depth} links deep")
    n_delta = sum(s["n_delta_pods"] for s in ck.save_stats)
    if n_delta <= 0:
        raise AssertionError("delta_chains=True wrote no delta pod")
    log(f"[store] delta chains: {len(tids)} commits, {n_delta} delta pods "
        f"to chain depth {depth} "
        f"({ck.store.stats.delta_bytes_written / 1e6:.3f} MB; whole-pod "
        f"oracle wrote {oracle.store.stats.pod_bytes_written / 1e9:.3f} GB, "
        f"delta store {ck.store.stats.pod_bytes_written / 1e9:.3f} GB); "
        f"manifests, pods and loads equal the oracle's "
        f"({time.perf_counter() - t0:.3f} s)")
    out["n_delta_pods"] = n_delta
    del ck, oracle

    # -- two writers on two threads and a collector, one FileStore --------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        base = Chipmink(FileStore(root), device=device, multi_writer=True,
                        lease_heartbeat=False)
        t_base = base.save(state)
        want = {t_base: embeds(state)}
        writers = [Chipmink(FileStore(root), device=device,
                            multi_writer=True, lease_heartbeat=False,
                            fsck_on_open=False) for _ in range(2)]
        collector = Chipmink(FileStore(root), device=device,
                             multi_writer=True, lease_heartbeat=False,
                             fsck_on_open=False)
        own = [snapshot(state) for _ in writers]
        gens = [torch.Generator(device=device).manual_seed(100 + i)
                for i in range(2)]
        errors, lock = [], threading.Lock()
        mine = [[], []]
        n_gc = [0]

        def write(i):
            try:
                for r in range(2):
                    sparse_round(own[i], gens[i])
                    emb = embeds(own[i])
                    tid = writers[i].save(own[i], branch=f"w{i}",
                                          parent=t_base if r == 0 else None)
                    with lock:
                        if tid in want:
                            raise AssertionError(f"TimeID {tid} minted twice")
                        want[tid] = emb
                    mine[i].append(tid)
            except BaseException as e:
                errors.append(e)

        def collect():
            try:
                for _ in range(2):
                    collector.gc()
                    n_gc[0] += 1
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=write, args=(i,))
                   for i in range(2)] + [threading.Thread(target=collect)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if any(th.is_alive() for th in threads):
            raise AssertionError("a writer or the collector hung")
        if errors:
            raise errors[0]
        for ck in writers + [collector, base]:
            if ck.close():
                raise AssertionError("multi-writer close() returned errors")
        reader = Chipmink(FileStore(root), device=device)
        rep = reader.last_fsck
        if rep.incomplete or rep.n_commits_complete != 5 or len(want) != 5:
            raise AssertionError(f"after the writers: fsck {rep}, "
                                 f"{len(want)} commits")
        for i in range(2):
            tip = reader.versions.branches[f"w{i}"]
            history = set(reader.versions.ancestors(tip))
            if tip != mine[i][-1] or not history >= {t_base, *mine[i]}:
                raise AssertionError(f"branch w{i} lost a commit: {mine[i]}")
        for tid, emb in want.items():
            check_commit(reader, tid, expect_state(state, emb))
    log(f"[store] multi-writer: 2 threads x 2 saves on one FileStore with "
        f"{n_gc[0]} concurrent gc() runs: TimeIDs {sorted(want)} unique, "
        f"every commit loads bit-exact ({time.perf_counter() - t0:.3f} s)")
    del own

    # -- refcount eviction against a full mark-and-sweep ------------------
    t0 = time.perf_counter()
    ck = Chipmink(MemoryStore(), device=device, refcounts=True)
    oracle = Chipmink(MemoryStore(), device=device)
    for c in (ck, oracle):
        c.save(state)
    t1 = ck.versions.head_commit()
    for kw in (dict(branch="b", parent=t1), dict(branch="b"),
               dict(parent=t1)):
        sparse_round(state, gen)
        if ck.save(state, **kw) != oracle.save(state, **kw):
            raise AssertionError("refcount and oracle TimeIDs differ")
    freed = ck.evict_branch("b")
    oracle.delete_branch("b")
    full = oracle.gc()
    if (sorted(freed.deleted_pod_digests) != sorted(full.deleted_pod_digests)
            or freed.n_commits_deleted != full.n_commits_deleted
            or not freed.n_pods_deleted):
        raise AssertionError(f"evict_branch freed {freed}, mark-and-sweep "
                             f"{full}")
    left = mark_and_sweep(ck.store, ck.versions, extra_roots=(ck._head,),
                          dry_run=True)
    if left.n_pods_deleted or left.n_commits_deleted or \
            ck.refcounts.rebuild():
        raise AssertionError("refcount index disagrees with a store scan")
    log(f"[store] refcounts: evict_branch freed {freed.n_commits_deleted} "
        f"commits and {freed.n_pods_deleted} pods "
        f"({freed.bytes_reclaimed / 1e6:.3f} MB), exactly what a full "
        f"mark-and-sweep frees ({time.perf_counter() - t0:.3f} s)")
    del ck, oracle

    # -- a torn pod mid-save, then a deep fsck on reopen ------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        fs = FaultyStore(FileStore(root))
        ck = Chipmink(fs, device=device)
        want = {}
        for _ in range(2):
            sparse_round(state, gen)
            want[ck.save(state)] = embeds(state)
        sparse_round(state, gen)
        attempt = embeds(state)
        fs.clear()
        fault = fs.arm("put_pod", "torn")
        try:
            ck.save(state)
        except InjectedCrash:
            pass
        if fault.n_fired != 1:
            raise AssertionError("the torn pod was never written")
        ck2 = Chipmink(FileStore(root), device=device, fsck_on_open="deep")
        rep = ck2.last_fsck
        if ck2.versions.head_commit() != max(want) or not rep.corrupt_pods:
            raise AssertionError(f"fsck after the crash: {rep}")
        for tid, emb in want.items():
            check_commit(ck2, tid, expect_state(state, emb))
        redo = ck2.save(expect_state(state, attempt))
        check_commit(ck2, redo, expect_state(state, attempt))
        if not fsck(ck2.store, repair=False, deep=True).clean:
            raise AssertionError("store not clean after the redo save")
    log(f"[store] FaultyStore torn pod mid-save: deep fsck on reopen swept "
        f"{len(rep.corrupt_pods)} corrupt pod(s) and "
        f"{rep.n_manifests_swept} manifest(s), head {max(want)}, every "
        f"surviving commit loads bit-exact, the redo save lands "
        f"({time.perf_counter() - t0:.3f} s)")
    launches = dict(fp.launches)
    if launches["fingerprint_cmp"] <= 0:
        raise AssertionError("store features launched no fingerprint_cmp")
    log(f"[store] kernel launches {launches}")
    out["launches"] = launches
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=QWEN1_5_0_5B["layers"],
                    help="depth of the main-path state (full width always)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import fingerprint as fp

    device = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[device.index])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(device)}")

    t0 = time.perf_counter()
    lib, report = fp.build_library()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.3f} s")
    for line in report.splitlines():
        log(f"[build] {line}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    cfg = dict(QWEN1_5_0_5B, layers=args.layers)
    chunk_bytes = 1 << 22
    main_shapes = bucket_shapes(cfg, chunk_bytes)
    small = dict(cfg, layers=2)
    sweep = [(1, 1, 0), (3, 4096, 0), (2, 5000, 0), (7, 1, 0), (64, 128, 0),
             (64, 4096, 0), (1, 1 << 20, 0), (64, 1 << 20, 0), (1, 3, 0),
             (2, 5, 0), (3, 4099, 0), (3, 1 << 20, 0), (149, 1 << 20, 0),
             (70000, 128, 0), (1, 1 << 20, 1), (3, 4096, 2), (5, 1 << 16, 3),
             (9, 4099, 3), (2, 7, 1), (1, 2, 1)]
    # every bucket shape a path gives the kernels: the 24-layer main,
    # async and checkout phases', and the 2-layer phases'
    shapes = list(sweep)
    for C, W in main_shapes + bucket_shapes(small, chunk_bytes):
        if (C, W, 0) not in shapes:
            shapes.append((C, W, 0))
    err, k1 = phase_kernels(shapes, set(main_shapes), gen, device)
    log(f"[kernels] main-path bucket shapes {main_shapes}")

    main = phase_main(cfg, gen, device)
    rung_launches, k2 = phase_rungs(small, gen, device)
    phase_filestore(small, gen, device)
    phase_async(cfg, gen, device)
    phase_checkout(cfg, gen, device)
    phase_store_features(small, gen, device)

    # the main path (phase 2) runs K1; K2 runs on the fused=False and
    # batched=False rungs (phase 3), each read just after its own run.
    launches = {"fingerprint_cmp": main["launches"]["fingerprint_cmp"],
                "fingerprint": rung_launches["fingerprint"]}
    log(f"[numbers] fingerprint_cmp launches per main-path save: "
        f"{launches['fingerprint_cmp'] / main['n_saves']}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on its path")
    times = {"fingerprint_cmp": k1, "fingerprint": k2}
    where = {"fingerprint_cmp": "over the main path's buckets",
             "fingerprint": "over one save of each of the fused=False and "
                            "batched=False rungs"}
    k2["max_abs_err"] = max(k2["max_abs_err"], err["fingerprint"])
    k1["max_abs_err"] = err["fingerprint_cmp"]
    kernels = []
    for name, meta in KERNELS.items():
        t = times[name]
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=t["max_abs_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None))
        log(f"[numbers] {name}: {t['ms']:.4f} ms per save {where[name]}, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
            f"version {t['plain_ms']:.4f} ms, launches {launches[name]}; "
            f"no single PyTorch call computes this digest"
            + (f"; profiler device time not measured at (rung, shape) "
               f"{t['not_measured']}" if t.get("not_measured") else ""))
    log(smi.stdout.strip().splitlines()[device.index])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
