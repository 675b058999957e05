#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one GPU and check it.

    python3 chip_smoke.py [--seed N] [--layers L]

Phases (each raises on failure; the script then exits non-zero):

  0. Print the card's name and power limit, build the fingerprint kernels
     from `src/repro_torch/csrc/` with nvcc and print the build time and
     the ptxas report.
  1. Hold both kernels against their plain PyTorch versions on the card,
     bit-exact, on a sweep of packed (C, W) matrices (W % 4 != 0,
     all-0xFFFFFFFF words, and views whose rows start 4, 8 or 12 bytes past
     a 16-byte boundary among them) and on every bucket shape the later
     phases give K2, at 24 layers and at 2, and phase 9's serving buckets
     (read from the port's planner).  Then K1 reading the leaves in place
     (`fingerprint_leaves_cmp`) against its plain version, bit-exact in
     digests, dirty flags and speculated payload, on the main path's plan
     at full depth and at 2 layers and on the serving plan: the real leaves
     as the later phases build them plus edge leaves (odd byte counts,
     scalars, an empty leaf, a transpose, views off 4- and 16-byte
     boundaries, a multi-chunk leaf with a partial tail), read where they
     lie and from a snapshot buffer pre-filled with 0xFF.  K1 and its plain
     version are timed at the main and serving plans and at phase 11's
     session plans (random leaves of each family's cache shapes), beside
     the bound of the bytes it reads in place and, once, the padded
     bucket matrices' bound it was measured against before.
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
     time per launch and its share of the byte bound at every distinct
     shape, apart from the host's cost of launching it: each shape in a
     window of its own after a discarded warm-up window, averaged over the
     records kept; a shape with no sound window fails the phase.
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
  9. Serving at full width (Qwen1.5-0.5B, always 24 layers): (a) the
     entry point `repro_torch.launch.serve.serve` with 4 sessions x 4
     requests, 32 generated tokens, 128 cache slots and a snapshot every 8
     tokens (2 KiB chunks), once synchronous and once with
     `async_mode=True`: 5 snapshots per session, each session's last
     snapshot far smaller than its tip, cross-session dedup > 1, the last
     session evicted with bytes reclaimed; prints decode and stall times,
     bytes per snapshot, per-stage times of a warm save and peak memory.
     (b) The same traffic through `SessionService`, `make_decode_step` and
     `init_model_params`, sync and async: every commit loads back bit-exact
     against a clone taken at its `save_session`; fetches counted per
     thread (every save <= 2, exactly 1 where speculation covered the
     dirty chunks, none in the caller of an async save, which runs under
     `torch.cuda.set_sync_debug_mode("error")`); `resume_session` on a
     second service over the same store restores a tip bit-exact and the
     next save reuses pods; one decode step runs under the sync debug
     mode, and decode steps are timed by CUDA events.  (c) K1's time at
     the serving plan against its bound (phase 1's timing).
 10. Training at full width (Qwen1.5-0.5B, 24 layers, 4.64 GB train state,
     8 x 128 tokens per step, 256 KiB chunks), through the entry point
     `repro_torch.launch.train.train(..., reduced=False, device="cuda")`,
     each step timed by CUDA events, each `save()` call timed (an async
     one under `set_sync_debug_mode("error")`) and every fetch counted per
     thread.  (a) 8 steps, a save every 4, async: losses finite, the
     last commit loads back bit-exact, 0 fetches in the caller and <= 2
     per save body; then K1 on the training plan (the final state's real
     leaves) bit-exact against its plain version and timed against its
     bound, with its wrapper's host time; then the step must descend: 8
     steps at lr 1e-4 on one fixed batch from a fresh init lower the loss
     (at the trainer's lr of 1e-3, the reference's, the full-width loss
     rises step after step, in the reference too: `experiments/
     train_trend.py --layers 12`), and
     one step runs under torch.profiler (device busy share).  (b) The same
     with the embedding and layers 0-21 frozen: the static checker's
     read-only set is exactly the frozen parameters, the second save skips
     them (active leaves, < 30% of the bootstrap's bytes, K1's real rows
     down by theirs).  (c) 4 steps with a sync save, a load of the newest
     commit, the state rebuilt on the card and the cursor restored, 4
     more: losses within rtol=atol=1e-4 of (a)'s 8.  (d) At 2 layers,
     `TrainingSupervisor` (a save every 3, async) over 8 steps with a
     failure injected at step 5 resumes from the step-3 commit and ends at
     step 8.
 11. The other model families, each at its full published configuration
     and one on the card at a time: granite-moe-3b-a800m (MoE),
     falcon-mamba-7b (SSM), recurrentgemma-9b (RG-LRU + local attention),
     whisper-base (encoder-decoder) and qwen2-vl-2b (M-RoPE).  (a) A
     2-layer copy at full width (3 layers for the hybrid, Whisper whole),
     drawn on the card and copied bit for bit to the CPU: 4 decode steps
     of B=4 on the card under `set_sync_debug_mode("error")` and on the
     CPU through the port's plain path; logits, K/V and recurrent states
     (and Whisper's encoder output, MoE router logits) all within twice
     the CPU tests' tolerance and >= 99.9% of each tensor within it
     (`MODEL_TOL`), greedy tokens and expert choices equal wherever the
     CPU's margin exceeds twice it.  (b) 2 sessions x 4 requests, 8
     prompt tokens (7 shared) + 8 generated, 128 cache slots, a snapshot
     every 8 tokens (2 KiB chunks) through `SessionService` at full
     depth: every commit loads back bit-exact, fetches counted (1-2 per
     save, none in a decode step), a recurrent family's second save
     dirties every chunk of its SSM or LRU states, Whisper's second
     save keeps every cross-K/V chunk and rewrites no cross pod; decode
     ms by CUDA events, stalls, stage times, bytes, dedup, peak memory;
     K1 held bit-exact against its plain version on the live Mamba and
     Whisper session states (its times at each family's plan come from
     phase 1).  (c) `serve(arch,
     reduced=False)` once, sync: 4 snapshots, K1 launched, the evicted
     session's bytes reclaimed.  Prints the phase's wall time.

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
import numpy as np
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
#: phase 9's traffic: `repro_torch.launch.serve.serve`'s defaults but the
#: session count and the width; snapshots of 2 KiB chunks (serve.py's), so
#: one token slot of one request of one K or V cache is one chunk
SERVE = dict(n_sessions=4, n_requests=4, gen_tokens=32, cache_len=128,
             save_every=8)
SERVE_CHUNK_BYTES = 1 << 11
#: phase 10's training runs: `repro_torch.launch.train.train`'s defaults
#: (8 x 128 tokens per step, 256 KiB chunks) for 8 steps, saving every 4
TRAIN = dict(steps=8, save_every=4, global_batch=8, seq_len=128)
TRAIN_CHUNK_BYTES = 1 << 18
#: phase 11's models, each at its full published configuration
#: (`src/repro_torch/configs/`): MoE, SSM, hybrid, enc-dec, VLM
FAMILY_ARCHS = ("granite-moe-3b-a800m", "falcon-mamba-7b",
                "recurrentgemma-9b", "whisper-base", "qwen2-vl-2b")
#: phase 11's traffic: 2 sessions x 4 requests, 8 prompt tokens (7
#: shared) + 8 generated, 128 cache slots, a snapshot every 8 tokens (2
#: per session, 2 KiB chunks)
FAMILY_SERVE = dict(n_sessions=2, n_requests=4, gen_tokens=8,
                    cache_len=128, save_every=8)

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


def timed(label: str, fn, *args):
    """fn(*args), with its wall time printed under `label`."""
    t = time.perf_counter()
    out = fn(*args)
    log(f"[time] {label}: {time.perf_counter() - t:.1f} s")
    return out


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


def check_param_specs(cfg: dict) -> None:
    """`param_specs` lists exactly the port's own declaration of the
    model, `param_defs(get_config("qwen1.5-0.5b"))` at `cfg`'s depth:
    the same paths, shapes and dtypes (a declared dtype of None is the
    parameters' bf16)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import api
    model = get_config("qwen1.5-0.5b")
    widths = dict(layers=model.n_layers, d_model=model.d_model,
                  n_heads=model.n_heads, n_kv_heads=model.n_kv_heads,
                  head_dim=model.hd, d_ff=model.d_ff, vocab=model.vocab)
    if widths != QWEN1_5_0_5B:
        raise AssertionError(f"QWEN1_5_0_5B {QWEN1_5_0_5B} is not the "
                             f"port's config {widths}")
    model = dataclasses.replace(model, n_layers=cfg["layers"])
    defs = api(model).param_defs(model)
    want = sorted(((path, d.shape, d.dtype or torch.bfloat16)
                   for path, d in defs.items()), key=lambda t: t[0])
    got = sorted(param_specs(cfg), key=lambda t: t[0])
    if got != want:
        raise AssertionError("param_specs differs from the port's "
                             "param_defs of qwen1.5-0.5b")


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

    def add_inplace(self, rows, leaves, plan, payload_words: int) -> None:
        """K1 over `rows` (a `RowTable`) read in place from `leaves`, with
        its grid `plan` (`inplace_plan`): read every row's bytes (each
        leaf byte once), the row table and grid (16 + 4 + 4 bytes per row,
        32 per item), the base addresses, the payload slots if any, and
        prev; write digests, dirty flags and payload.  The weights are
        needed once per position of the widest row."""
        N = rows.n_rows
        n_items = plan[1].shape[0]
        data = int((rows.nfull * 4 + rows.part).sum())
        self.bytes += (data + 24 * N + 32 * n_items + 8 * len(leaves)
                       + (4 * N if payload_words else 0) + 16 * N
                       + 16 * N + 4 * N + 4 * payload_words)
        widest = int(rows.nwords.max()) if N else 0
        self.ops += (int(rows.nwords.sum()) * LANES * OPS_PER_WORD_LANE
                     + widest * LANES * OPS_PER_WEIGHT)

    @property
    def ms(self) -> float:
        return max(self.bytes / HBM_BYTES_PER_S,
                   self.ops / INT32_OPS_PER_S) * 1e3

    @property
    def by(self) -> str:
        return ("operations" if self.ops / INT32_OPS_PER_S
                > self.bytes / HBM_BYTES_PER_S else "bytes")


def device_records(run, names) -> dict:
    """torch.profiler's device records of the kernels whose names contain
    each of `names`, over one call of `run` (which launches them): the
    profiler first traces a warm-up call of `run` and discards it, then
    keeps the next (`schedule(warmup=1, active=1)`), since a window's
    first launches can go unrecorded.  {name: (records kept, mean device
    us per record)}; a record is one launch's own device time.  The
    profiler may still drop part or all of a window: callers retake it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    kept = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kept.append(p.key_averages())) \
            as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    total = {name: [0, 0.0] for name in names}
    for e in (kept[-1] if kept else []):
        for name in names:
            if e.device_type == DeviceType.CUDA and name in e.key:
                total[name][0] += e.count
                total[name][1] += e.self_device_time_total
    return {name: (n, us / n if n else None)
            for name, (n, us) in total.items()}


def max_abs_diff(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not got.numel():
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def phase_kernels(shapes, gen, device):
    """Both kernels vs their plain versions, bit-exact on packed matrices
    `shapes`, each (C, W, offset): the words are a view that starts
    `offset` words into a fresh tensor, so its rows start 4 * offset
    bytes past a 16-byte boundary.  K1 runs here through
    `fingerprint_words_cmp`, which describes the matrix to it as one leaf
    of C rows.  Returns the max abs error per kernel."""
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.kernels import ref
    err = {"fingerprint": 0, "fingerprint_cmp": 0}
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
        log(f"[kernels] {where}: K1 and K2 bit-exact with their plain "
            f"versions")
        del words, lengths, plain, prev, d1, d2, m1, pd, pm
    return err


def edge_leaves(device) -> list:
    """Leaves whose rows a row table must get right: byte counts that end
    mid-word, 0-dim scalars of 1, 4 and 8 bytes, an empty leaf, a
    transpose, views t[1:] off 4- and 16-byte boundaries, and a leaf of
    several 4 MiB chunks with a partial tail."""
    g = torch.Generator(device=device).manual_seed(7)

    def r(*shape):
        return torch.randn(shape, generator=g, device=device)

    return [r(7).to(torch.bfloat16), (r(3) * 50).to(torch.int8),
            (r(1) * 50).to(torch.int8), r(2) > 0, r(3) > 0,
            torch.tensor(-3, dtype=torch.int8, device=device),
            torch.tensor(2.5, device=device),
            torch.tensor(-1.25, dtype=torch.float64, device=device),
            torch.zeros((0, 3), device=device), r(37, 5).T,
            r(301).to(torch.bfloat16)[1:], (r(203) * 50).to(torch.int8)[1:],
            r(130)[1:], r(4096 * 1024 * 2 + 3001)]


def snapshot_ff(leaves) -> list:
    """The leaves copied into one snapshot buffer (`ops.snapshot_tensors`
    layout) that held 0xFF before the copy: its gap bytes stay 0xFF."""
    from repro_torch.kernels import ops
    views, buf = ops.snapshot_tensors(leaves)
    buf.fill_(0xFF)
    with torch.no_grad():
        torch._foreach_copy_(views, list(leaves))
    return views


def inplace_items(state: dict, chunk_bytes: int) -> list:
    """(key, tensor) of every leaf a save digests, in the save's order."""
    from repro_torch.core.graph import build_graph
    graph = build_graph(state, chunk_bytes=chunk_bytes)
    return [(leaf.key, graph.arrays[leaf.key])
            for leaf in graph.leaf_nodes()
            if isinstance(graph.arrays[leaf.key], torch.Tensor)]


def check_inplace(name: str, items, chunk_bytes: int, gen, device) -> int:
    """K1 over `items` in place against its plain version, bit-exact:
    digests, dirty flags (prev holds the right digest in every other
    row) and the payload of every 7th row.  Returns the max abs error."""
    from repro_torch.kernels import batch, ref
    from repro_torch.kernels import fingerprint as fp
    plan = batch.plan_leaves(batch._specs(items), chunk_bytes)
    rows = batch._plan_rows(plan)
    leaves = [fp.readable_leaf(t) for _, t in items]
    spec = np.arange(0, rows.n_rows, 7)
    slots = fp.payload_slots(rows, fp.leaf_mis(leaves), spec)
    lo, hi = torch.iinfo(torch.int32).min, torch.iinfo(torch.int32).max
    prev = torch.randint(lo, hi, (rows.n_rows, 4), generator=gen,
                         device=device, dtype=torch.int32)
    want = ref.fingerprint_leaves_cmp_ref(leaves, rows, prev, slots, seed=3)
    prev[::2] = want[0][::2]
    want = ref.fingerprint_leaves_cmp_ref(leaves, rows, prev, slots, seed=3)
    got = fp.fingerprint_leaves_cmp(leaves, rows, prev, slots, seed=3)
    torch.cuda.synchronize()
    err = max(max_abs_diff(got[0], want[0]), max_abs_diff(got[1], want[1]))
    for r in spec:
        a, n = int(slots[r]), int(rows.nwords[r])
        err = max(err, max_abs_diff(got[2][a:a + n], want[2][a:a + n]))
    if err or not 0 < int(want[1].sum()) < rows.n_rows:
        raise AssertionError(f"fingerprint_cmp differs from its plain "
                             f"version in place on {name}")
    log(f"[inplace] {name}: {len(items)} leaves, {rows.n_rows} rows "
        f"({plan.n_chunks} real), {len(spec)} speculated: digests, dirty "
        f"flags and payload bit-exact with the plain version")
    return err


def time_inplace(name: str, items, chunk_bytes: int, device) -> dict:
    """K1 in place over `items` as a warm save runs it (no speculated
    rows): CUDA-event ms of back-to-back wrapper calls, the host time of
    one wrapper call (the calls run ahead of the card while the host is
    the slower), its kernel's device time by torch.profiler, the plain
    version's ms and the bound; beside it, once, the bound of the padded
    bucket matrices K1 read before it read the leaves in place."""
    from repro_torch.kernels import batch, ref
    from repro_torch.kernels import fingerprint as fp
    plan = batch.plan_leaves(batch._specs(items), chunk_bytes)
    rows = batch._plan_rows(plan)
    leaves = [t for _, t in items]
    prev = torch.zeros((rows.n_rows, 4), dtype=torch.int32, device=device)

    def run():
        return fp.fingerprint_leaves_cmp(leaves, rows, prev)

    ms = cuda_ms(run, 20)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        run()
    host_ms = (time.perf_counter() - t) * 1e3 / 20
    readable = [fp.readable_leaf(t) for t in leaves]
    plain_ms = cuda_ms(
        lambda: ref.fingerprint_leaves_cmp_ref(readable, rows, prev), 2)
    # the profiler drops a varying number of a window's first records
    # (all of a 5-launch window at times, even early in the script), so a
    # window holds 40 launches and is retaken up to 5 times
    n_calls, n_windows = 40, 5
    for attempt in range(1, n_windows + 1):
        n_kernel, device_us = device_records(
            lambda: [run() for _ in range(n_calls)],
            ("leaves_cmp_kernel",))["leaves_cmp_kernel"]
        if n_kernel >= n_calls / 2:
            break
        log(f"[inplace]   window {attempt} of {n_windows} at the {name} "
            f"plan: the profiler kept {n_kernel} records of {n_calls} "
            f"launches")
    bound = Bound()
    bound.add_inplace(rows, readable, fp.inplace_plan(
        rows, fp.leaf_mis(readable).tobytes()), payload_words=0)
    padded = Bound()
    for b in plan.buckets:
        padded.add(b.padded_rows, b.width, compare=True)
    if n_kernel < n_calls / 2:
        raise AssertionError(f"K1's device time at the {name} plan: no "
                             f"sound profiling window in {n_windows}")
    device_ms = device_us / 1e3
    log(f"[inplace] K1 at the {name} plan ({len(items)} leaves, "
        f"{rows.n_rows} rows): {ms:.4f} ms per call by CUDA events, "
        f"kernel {device_ms:.4f} ms by torch.profiler ({n_kernel} of "
        f"{n_calls} launches recorded), bound {bound.ms:.4f} ms "
        f"({bound.by}: {bound.bytes / 1e9:.4f} GB); the wrapper's host "
        f"time {host_ms:.4f} ms per call; plain version {plain_ms:.4f} ms")
    log(f"[inplace]   before, K1 read the padded bucket matrices "
        f"{[(b.padded_rows, b.width) for b in plan.buckets]}: "
        f"{padded.bytes / 1e9:.4f} GB, whose bound {padded.ms:.4f} ms the "
        f"earlier share was taken against")
    return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                bound_ms=bound.ms, bound_by=bound.by, host_ms=host_ms,
                n_rows=rows.n_rows)


def phase_inplace(cfg: dict, gen, device) -> dict:
    """K1 over leaves in place against its plain version on the main
    path's plan at cfg's depth and at 2 layers and on the serving plan,
    real leaves built as the later phases build them plus
    `edge_leaves`, read where they lie and from a 0xFF-filled snapshot
    buffer; then timed at the main and serving plans and at phase 11's
    session plans.  Returns (max abs error, K1's numbers per plan)."""
    err = 0
    times = {}
    edge = [(f"edge/{i}", t) for i, t in enumerate(edge_leaves(device))]
    paths = (("main", cfg, 1 << 22), ("main-2", dict(cfg, layers=2), 1 << 22),
             ("serving", None, SERVE_CHUNK_BYTES))
    for name, c, chunk in paths:
        state = (make_state(c, gen, device) if c is not None
                 else session_state("qwen1.5-0.5b", SERVE["n_requests"],
                                    SERVE["cache_len"], device))
        items = inplace_items(state, chunk)
        for label, its in ((name, items + edge),
                           (f"{name}, snapshot buffer 0xFF",
                            list(zip([k for k, _ in items + edge],
                                     snapshot_ff([t for _, t in
                                                  items + edge]))))):
            err = max(err, check_inplace(label, its, chunk, gen, device))
            del its
        if name in ("main", "serving"):
            times[name] = time_inplace(name, items, chunk, device)
        del state, items
        torch.cuda.empty_cache()
    # K1's times at phase 11's session plans, here, where the profiler
    # keeps its windows (late in the script it can lose every record of a
    # short one); phase 11 checks K1 on the live session states
    for arch in FAMILY_ARCHS:
        items = inplace_items(session_state(
            arch, FAMILY_SERVE["n_requests"], FAMILY_SERVE["cache_len"],
            device), SERVE_CHUNK_BYTES)
        times[arch] = time_inplace(arch, items, SERVE_CHUNK_BYTES, device)
        del items
        torch.cuda.empty_cache()
    return err, times


def session_state(arch: str, n_requests: int, cache_len: int,
                  device) -> dict:
    """A full-width session state of `arch` as `serve` snapshots it:
    random leaves of `cache_spec`'s shapes (K/V rings, conv windows, SSM
    and LRU states, cross K/V) and the cache's position."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import CacheSpec, cache_spec
    spec = cache_spec(get_config(arch), n_requests, cache_len)
    g = torch.Generator(device=device).manual_seed(11)

    def fill(t):
        if not isinstance(t, CacheSpec):
            return {k: fill(v) for k, v in t.items()}
        if not t.shape:
            return torch.tensor(cache_len // 2, dtype=t.dtype, device=device)
        return torch.randn(t.shape, generator=g, device=device).to(t.dtype)

    return {"cache": fill(spec), "cursor": {"pos": cache_len // 2}}



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
    # K1 reads the leaves in place: no packing copy, no zeroed matrix
    packer = [e.key for e in avgs if "Memcpy DtoD" in e.key
              or "FillFunctor" in e.key]
    if packer:
        raise AssertionError(f"the fused save still packs: {packer}")


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
    out = dict(ms=0.0, plain_ms=0.0, max_abs_err=0, device_ms=0.0)
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
        for shape, t in times.items():
            per_launch = t["kernel_us"] + t["memset_us"]
            device_us += t["n"] * per_launch
            one = Bound()
            one.add(*shape, compare=False)
            log(f"[rungs]   {shape} x{t['n']} per save: device "
                f"{per_launch:.3f} us per launch (kernel "
                f"{t['kernel_us']:.3f} + memset {t['memset_us']:.3f}; "
                f"records kept (kernel, memset, launches) {t['records']}), "
                f"bound {one.ms * 1e3:.3f} us ({one.by}), "
                f"{100 * one.ms * 1e3 / per_launch:.1f}% of it")
        out["device_ms"] += device_us / 1e3
        log(f"[rungs] K2 on the {rung} rung: device time "
            f"{device_us / 1e3:.4f} ms per save by torch.profiler at every "
            f"shape, bound {rung_bound.ms:.4f} ms; the rest of the "
            f"{ms:.4f} ms is the host launching it")
    out.update(bound_ms=bound.ms, bound_by=bound.by)
    return out


def k2_device_times(ins) -> dict:
    """K2's device time per launch for each distinct (C, W) of `ins`, from
    torch.profiler's records of its kernel (`digest_kernel`) and of the
    memset that zeroes the digests of a launch cut into several segments:
    each shape in its own window (`device_records`) of at least 24
    launches, averaged over the records kept.  A window is taken again,
    up to 3 times, when the profiler kept fewer than half the launches or
    read a launch as faster than its byte bound, which no launch can be;
    a shape with no sound window fails the phase.  {shape: dict(n=inputs
    of that shape, kernel_us=, memset_us=, records=)}"""
    from repro_torch.kernels import fingerprint as fp
    by_shape = {}
    for words, lengths in ins:
        by_shape.setdefault(tuple(words.shape), []).append((words, lengths))
    times = {}
    for shape, group in by_shape.items():
        reps = max(3, -(-24 // len(group)))
        n = reps * len(group)
        split = fp.digest_plan(*shape)[1] > 1
        floor = Bound()
        floor.add(*shape, compare=False)

        def run():
            for _ in range(reps):
                for words, lengths in group:
                    fp.fingerprint_words(words, lengths)

        for attempt in range(1, 4):
            rec = device_records(run, ("digest_kernel", "Memset"))
            (nk, kernel_us), (nm, memset_us) = \
                rec["digest_kernel"], rec["Memset"]
            if nk < n / 2 or (split and nm < n / 2) or (not split and nm):
                log(f"[rungs]   window {attempt} of 3 at {shape}: the "
                    f"profiler kept {nk} kernel and {nm} memset records "
                    f"of {n} launches")
                continue
            t = dict(n=len(group), kernel_us=kernel_us,
                     memset_us=memset_us or 0.0, records=(nk, nm, n))
            if t["kernel_us"] + t["memset_us"] < floor.ms * 1e3:
                log(f"[rungs]   window {attempt} of 3 at {shape}: the "
                    f"profiler read {t}, below the byte bound")
                continue
            times[shape] = t
            break
        else:
            raise AssertionError(f"K2's device time at {shape}: no sound "
                                 f"profiling window in 3")
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


# --------------------------------------------------------------------------
# phase 9: serving
# --------------------------------------------------------------------------

def serving_bucket_shapes():
    """(padded_rows, width) of every bucket a full-width session save
    digests: the port's planner over the session state's tensors (the K/V
    caches and the cache's position) at 2 KiB chunks."""
    from repro_torch.configs import get_config
    from repro_torch.core.graph import dtype_name
    from repro_torch.kernels.batch import plan_leaves
    from repro_torch.models.transformer import cache_spec
    spec = cache_spec(get_config("qwen1.5-0.5b"), SERVE["n_requests"],
                      SERVE["cache_len"])
    specs = [(f"cache/layers/{i}/{k}", s.shape, dtype_name(s.dtype))
             for i, lc in spec["layers"].items() for k, s in lc.items()]
    specs.append(("cache/pos", (), dtype_name(spec["pos"].dtype)))
    return [(b.padded_rows, b.width)
            for b in plan_leaves(tuple(specs), SERVE_CHUNK_BYTES).buckets]


STAGES = ("t_graph", "t_avf", "t_digest", "t_podding", "t_decide",
          "t_gather", "t_write")


def _mean_stages(stats, stalls=None) -> dict:
    """Mean stage times of `stats` (seconds) and, given the stalls of
    sync saves, of the rest of each stall that no stage times (flip
    tracking between the digest and podding, manifest, refcount index
    and refs)."""
    out = {k: sum(s[k] for s in stats) / len(stats) for k in STAGES}
    if stalls is not None:
        out["untimed"] = sum(t - sum(s[k] for k in STAGES)
                             for s, t in zip(stats, stalls)) / len(stats)
    return out


def profile_device(fn, n: int):
    """(device busy ms, wall ms, device ops) per call of `fn`, over `n`
    calls under torch.profiler (wall inflated by the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n
    avgs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in avgs) / 1e3 / n, wall,
            sum(e.count for e in avgs) / n)


def phase_serve(device) -> dict:
    """9a: the serving entry point at full width, sync and async (see the
    module docstring, phase 9)."""
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.launch.serve import serve
    n = SERVE["n_sessions"]
    n_snaps = (8 + SERVE["gen_tokens"]) // SERVE["save_every"]
    out = {}
    for async_mode in (False, True):
        mode = "async" if async_mode else "sync"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        fp.reset_launch_counts()
        res = serve("qwen1.5-0.5b", reduced=False, async_mode=async_mode,
                    device="cuda", log=False, **SERVE)
        torch.cuda.synchronize()
        launches = dict(fp.launches)
        peak = torch.cuda.max_memory_allocated(device)
        svc, snaps, fleet = res["service"], res["snap_stats"], res["fleet"]
        # TimeID order is submission order: round-robin over the sessions
        if len(snaps) != n * n_snaps:
            raise AssertionError(f"{mode}: {len(snaps)} snapshots, want "
                                 f"{n_snaps} per session")
        written = [[s["bytes_written"] for s in snaps[k::n]]
                   for k in range(n)]
        dag = svc.pool[0].versions
        for k in range(n - 1):        # the last session was evicted
            ctx = svc.sessions[f"s{k}"]
            if ctx.n_saves != n_snaps or ctx.head != snaps[-n + k]["time_id"]:
                raise AssertionError(f"{mode}: session s{k} made "
                                     f"{ctx.n_saves} saves, head {ctx.head}")
            tip = sum(svc.store.pod_nbytes(d)
                      for d in dag.pod_digests_of(ctx.head))
            if not written[k][-1] < tip / 4:
                raise AssertionError(f"{mode}: s{k}'s last snapshot wrote "
                                     f"{written[k][-1]} bytes of a "
                                     f"{tip}-byte tip")
        if not written[0][-1] < written[0][0] / 4:
            raise AssertionError(f"{mode}: s0's last snapshot wrote "
                                 f"{written[0][-1]} bytes, its first "
                                 f"{written[0][0]}")
        if not fleet["dedup_ratio"] > 1:
            raise AssertionError(f"{mode}: dedup ratio {fleet['dedup_ratio']}")
        if not res["evict_stats"].bytes_reclaimed > 0:
            raise AssertionError(f"{mode}: eviction reclaimed nothing")
        if launches["fingerprint_cmp"] <= 0:
            raise AssertionError(f"{mode}: serving launched no "
                                 f"fingerprint_cmp")
        # stalls in submission order, which is TimeID order
        warm = [(s, t) for s, t in zip(snaps, svc.save_stalls)
                if s["n_pods_reused"] > 0]
        fetches = collections.Counter(
            s["n_digest_syncs"] + s["n_gather_syncs"] for s in snaps)
        steps = n * (8 + SERVE["gen_tokens"])
        log(f"[serve] {mode}: {steps} decode steps and {len(snaps)} "
            f"snapshots in {res['wall']:.3f} s ({res['wall'] / steps * 1e3:.3f}"
            f" ms per step, saves included); save stall p50 "
            f"{fleet['p50_save_stall_s'] * 1e3:.3f} ms, p99 "
            f"{fleet['p99_save_stall_s'] * 1e3:.3f} ms; dedup "
            f"{fleet['dedup_ratio']:.4f}x ({fleet['logical_tip_bytes']} "
            f"logical / {fleet['physical_tip_bytes']} physical tip bytes); "
            f"evict {fleet['p50_evict_s'] * 1e3:.3f} ms reclaiming "
            f"{res['evict_stats'].bytes_reclaimed} bytes; peak device "
            f"memory {peak / 1e9:.3f} GB; kernel launches {launches}")
        log(f"[serve] {mode}: bytes written per snapshot, by session: "
            f"{written}; fetches per save body: {dict(fetches)}")
        log(f"[serve] {mode}: stalls per save (ms): "
            f"{[round(t * 1e3, 3) for t in svc.save_stalls]}")
        stats, stalls = zip(*warm)
        stages = _mean_stages(stats, None if async_mode else stalls)
        log(f"[serve] {mode}: mean stage times of the {len(warm)} warm saves "
            f"(s; 'untimed' is the rest of a sync save's stall): "
            f"{json.dumps(stages)}; last warm save "
            + json.dumps({k: warm[-1][0][k] for k in (
                "time_id", "t_graph", "t_digest", "t_podding", "t_gather",
                "t_write", "n_dirty_chunks", "n_spec_predicted",
                "n_spec_misses", "pods_written", "n_pods_reused",
                "bytes_written")}))
        out[mode] = dict(launches=launches, n_saves=len(snaps), peak=peak,
                         fleet=fleet, wall=res["wall"], steps=steps,
                         stages=stages)
        svc.close()
        del res, svc
    return out


def phase_sessions(gen, device) -> dict:
    """9b: the serving traffic through the public modules, every commit
    checked bit-exact and every fetch counted (see the module docstring,
    phase 9)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import LGA, MemoryStore
    from repro_torch.models.model import api, init_model_params
    from repro_torch.sessions import SessionService
    from repro_torch.train.serve_step import make_decode_step
    cfg = get_config("qwen1.5-0.5b")
    m = api(cfg)
    params = init_model_params(cfg, gen, device=device)
    step = make_decode_step(cfg)
    B, T, n = SERVE["n_requests"], SERVE["cache_len"], SERVE["n_sessions"]
    n_tokens = 8 + SERVE["gen_tokens"]
    svc_kw = dict(policy=LGA(), chunk_bytes=SERVE_CHUNK_BYTES, device=device)
    out = {}

    # one decode step with host syncs turned into errors, then its time
    cache = m.init_cache(cfg, B, T, device=device)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
    logits, cache = step(params, cache, tok)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = step(params, cache, tok)
        tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    finally:
        torch.cuda.set_sync_debug_mode(0)

    def decode():
        nonlocal logits, cache
        logits, cache = step(params, cache, tok)

    out["decode_ms"] = [cuda_ms(decode, 20) for _ in range(3)]
    log(f"[sessions] a full-width decode step (B={B}, {T} cache slots) "
        f"made no host sync under set_sync_debug_mode('error'); "
        f"{out['decode_ms']} ms per step by CUDA events (3 runs of 20)")
    busy, wall, n_ops = profile_device(decode, 5)
    log(f"[trace] decode step under the profiler: device busy "
        f"{busy:.3f} ms of {wall:.3f} ms wall per step "
        f"({100 * busy / wall:.1f}%), {n_ops:.0f} device ops per step")
    del cache, logits

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, size=(B, 7)).astype(np.int32)
    prompts = [torch.from_numpy(np.concatenate(
        [shared, rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)],
        axis=1)).to(device) for _ in range(n)]
    stores = {}
    for async_mode in (False, True):
        mode = "async" if async_mode else "sync"
        svc = SessionService(MemoryStore(), pool_size=n,
                             async_mode=async_mode, **svc_kw)
        caches = [m.init_cache(cfg, B, T, device=device) for _ in range(n)]
        toks = [None] * n
        clones, per_save = {}, []
        caller = threading.get_ident()
        for k in range(n):
            svc.open_session(f"s{k}")
        with FetchesByThread() as fetches:
            for i in range(n_tokens):
                for k in range(n):
                    tok = prompts[k][:, i:i + 1] if i < 8 else toks[k]
                    logits, caches[k] = step(params, caches[k], tok)
                    toks[k] = torch.argmax(logits, dim=-1, keepdim=True)\
                        .to(torch.int32)
                    if (i + 1) % SERVE["save_every"]:
                        continue
                    state = {"cache": caches[k], "cursor": {"pos": i + 1}}
                    clone = snapshot(state)
                    f0 = fetches.counts[caller]
                    if async_mode:
                        torch.cuda.synchronize()
                        torch.cuda.set_sync_debug_mode("error")
                    try:
                        if not async_mode and k == 0 and i + 1 == n_tokens:
                            busy, wall, n_ops = profile_device(
                                lambda: svc.save_session("s0", state), 1)
                            tid = svc.sessions["s0"].head
                            log(f"[trace] s0's last sync save under the "
                                f"profiler: device busy {busy:.3f} ms of "
                                f"{wall:.3f} ms wall ({100 * busy / wall:.2f}"
                                f"%), {n_ops:.0f} device ops")
                        else:
                            tid = svc.save_session(f"s{k}", state)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                    per_save.append((k, tid, fetches.counts[caller] - f0))
                    clones[tid] = clone
            for ck in svc.pool:
                ck.wait()
        torch.cuda.synchronize()
        stats = {s["time_id"]: s for ck in svc.pool for s in ck.save_stats}
        counts = {"1 fetch": 0, "2 fetches": 0}
        covered = 0
        for k, tid, caller_fetches in per_save:
            s = stats[tid]
            body = s["n_digest_syncs"] + s["n_gather_syncs"]
            if (async_mode and caller_fetches) or \
                    (not async_mode and caller_fetches != body):
                raise AssertionError(f"{mode} save {tid}: {caller_fetches} "
                                     f"fetches in the caller, stats {body}")
            if not 1 <= body <= 2:
                raise AssertionError(f"{mode} save {tid}: {body} fetches")
            counts["1 fetch" if body == 1 else "2 fetches"] += 1
            if s["n_pods_reused"] > 0 and s["n_spec_misses"] == 0:
                covered += 1
                if body != 1:
                    raise AssertionError(f"{mode} save {tid}: speculation "
                                         f"covered it, {body} fetches")
        body_total = sum(c for th, c in fetches.counts.items()
                         if th != caller)
        want_body = sum(s["n_digest_syncs"] + s["n_gather_syncs"]
                        for s in stats.values()) if async_mode else 0
        if body_total != want_body:
            raise AssertionError(f"{mode}: bodies fetched {body_total} "
                                 f"times, their stats count {want_body}")
        t0 = time.perf_counter()
        for tid, clone in clones.items():
            got = svc.pool[0].load(time_id=tid)
            bit_equal(got, clone)
            del got
        t_load = time.perf_counter() - t0
        prefix = all(torch.equal(caches[0]["layers"][i][kv][:, :7],
                                 caches[k]["layers"][i][kv][:, :7])
                     for k in range(1, n) for i in caches[0]["layers"]
                     for kv in ("k", "v"))
        tables = sum(t.numel() * t.element_size()
                     for ctx in svc.sessions.values()
                     for t in ctx.detector._dev_table.digs)
        log(f"[sessions] {mode}: {len(per_save)} saves, fetches per save "
            f"{counts} ({covered} warm saves covered by speculation, each "
            f"1 fetch), caller fetches "
            f"{'0 under set_sync_debug_mode(error)' if async_mode else 'as the stats'}"
            f"; all {len(clones)} commits load back bit-exact "
            f"({t_load:.3f} s); the 7-token prefix's KV is bit-identical "
            f"across sessions: {prefix}; device digest tables of the "
            f"{len(svc.sessions)} sessions: {tables} bytes")
        out[mode] = dict(counts=counts, covered=covered, prefix=prefix,
                         tables=tables)
        stores[mode] = (svc, clones, per_save, caches, toks)

    # migration: a second service over the sync service's store
    svc, clones, per_save, caches, toks = stores["sync"]
    tip = svc.sessions["s1"].head
    other = SessionService(svc.store, pool_size=1, **svc_kw)
    t0 = time.perf_counter()
    state = other.resume_session("s1")
    torch.cuda.synchronize()
    t_resume = time.perf_counter() - t0
    bit_equal(state, clones[tip])
    cs = other.sessions["s1"].last_checkout_stats
    logits, state["cache"] = step(params, state["cache"], toks[1])
    state["cursor"]["pos"] += 1
    want = snapshot(state)
    with FetchesByThread() as fetches:
        tid = other.save_session("s1", state)
    s = other.pool[0].save_stats[-1]
    n_f = sum(fetches.counts.values())
    if s["n_pods_reused"] <= 0 or not 1 <= n_f <= 2 or \
            other.store.get_manifest(tid)["parent"] != tip:
        raise AssertionError(f"save after resume: {n_f} fetches, {s}")
    bit_equal(other.pool[0].load(time_id=tid), want)
    log(f"[sessions] resume_session('s1') on a second service: tip {tip} "
        f"bit-exact in {t_resume:.3f} s ({cs.n_pods_fetched} of "
        f"{cs.n_pods} pods read, {cs.read_bytes} bytes); the next save "
        f"made {n_f} fetch(es), reused {s['n_pods_reused']} pods, wrote "
        f"{s['pods_written']} and loads back bit-exact")
    for svc, *_ in stores.values():
        svc.close()
    other.close()
    return out


# --------------------------------------------------------------------------
# phase 10: training
# --------------------------------------------------------------------------

def host_rss_gb() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def observe_train(device, **kw) -> dict:
    """One `repro_torch.launch.train.train("qwen1.5-0.5b", reduced=False,
    device="cuda", **kw)` run, instrumented through the names that module
    calls: each step timed by CUDA events (not the static checker's trace
    of it), the checker's seconds, every `save()` call's host time (an
    async one under `set_sync_debug_mode("error")`), K1's row table per
    launch, fetches per thread, K1 launches, peak device memory."""
    import repro_torch.launch.train as lt
    from repro_torch.kernels import batch as kb
    from repro_torch.kernels import fingerprint as fp
    real = (lt.Chipmink, lt.make_train_step, lt.readonly_state_leaves,
            kb.fingerprint_leaves_cmp)
    obs = dict(events=[], save_calls=[], k1_rows=[], trace_s=None)
    tracing = [False]

    class Observed(real[0]):
        def save(self, state, **kw):
            if self.async_mode:
                torch.cuda.set_sync_debug_mode("error")
            t = time.perf_counter()
            try:
                return super().save(state, **kw)
            finally:
                obs["save_calls"].append(time.perf_counter() - t)
                torch.cuda.set_sync_debug_mode(0)

    def make_train_step(*args, **kw):
        step = real[1](*args, **kw)

        def timed(state, batch):
            if tracing[0]:
                return step(state, batch)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = step(state, batch)
            ev[1].record()
            obs["events"].append(ev)
            return out
        return timed

    def readonly_state_leaves(*args, **kw):
        tracing[0] = True
        t = time.perf_counter()
        try:
            return real[2](*args, **kw)
        finally:
            tracing[0] = False
            obs["trace_s"] = time.perf_counter() - t

    def fingerprint_leaves_cmp(leaves, table, *args, **kw):
        obs["k1_rows"].append((table.n_rows, int((table.lengths > 0).sum())))
        return real[3](leaves, table, *args, **kw)

    (lt.Chipmink, lt.make_train_step, lt.readonly_state_leaves,
     kb.fingerprint_leaves_cmp) = (Observed, make_train_step,
                                   readonly_state_leaves,
                                   fingerprint_leaves_cmp)
    caller = threading.get_ident()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    fp.reset_launch_counts()
    try:
        with FetchesByThread() as fetches:
            t0 = time.perf_counter()
            out = lt.train("qwen1.5-0.5b", reduced=False, device="cuda",
                           log=False, **kw)
            torch.cuda.synchronize()
            obs["wall"] = time.perf_counter() - t0
    finally:
        (lt.Chipmink, lt.make_train_step, lt.readonly_state_leaves,
         kb.fingerprint_leaves_cmp) = real
    obs.update(out=out, launches=fp.launches["fingerprint_cmp"],
               peak=torch.cuda.max_memory_allocated(device),
               caller_fetches=fetches.counts[caller],
               body_fetches=sum(n for th, n in fetches.counts.items()
                                if th != caller),
               step_ms=[a.elapsed_time(b) for a, b in obs.pop("events")])
    stats = out["chipmink"].save_stats
    losses = out["losses"]
    if not (np.isfinite(losses).all() and len(losses) == kw["steps"]):
        raise AssertionError(f"losses {losses}")
    if any(s["n_digest_syncs"] + s["n_gather_syncs"] > 2 for s in stats):
        raise AssertionError(f"a save body made more than 2 fetches: "
                             f"{[(s['n_digest_syncs'], s['n_gather_syncs']) for s in stats]}")
    if kw.get("async_save", True):
        if obs["caller_fetches"]:
            raise AssertionError(f"an async save() fetched "
                                 f"{obs['caller_fetches']} times in the caller")
        if obs["body_fetches"] != sum(s["n_digest_syncs"] + s["n_gather_syncs"]
                                      for s in stats):
            raise AssertionError("body fetches differ from their stats")
    if len(obs["k1_rows"]) != len(stats) or (
            device.type == "cuda" and obs["launches"] != len(stats)):
        raise AssertionError(f"{obs['launches']} K1 launches and "
                             f"{len(obs['k1_rows'])} wrapper calls for "
                             f"{len(stats)} saves")
    return obs


def log_train(name: str, obs: dict, card: str) -> None:
    out = obs["out"]
    stats = out["chipmink"].save_stats
    log(f"[train] {name} ({card}): losses {out['losses']}; step ms by CUDA "
        f"events {obs['step_ms']}; static checker {obs['trace_s']:.3f} s, "
        f"{len(out['readonly'])} read-only leaves; {len(stats)} saves, "
        f"save() calls {[round(t * 1e3, 3) for t in obs['save_calls']]} ms; "
        f"fetches: caller {obs['caller_fetches']}, bodies "
        f"{[s['n_digest_syncs'] + s['n_gather_syncs'] for s in stats]}; "
        f"K1 launches {obs['launches']}, rows (all, real) {obs['k1_rows']}; "
        f"wall {obs['wall']:.3f} s; peak device memory "
        f"{obs['peak'] / 1e9:.3f} GB; peak host RSS {host_rss_gb():.3f} GB")
    for s in stats:
        body = sum(s.get(k, 0.0) for k in STAGES)
        log(f"[train] {name} save " + json.dumps(dict(body_s=body, **{
            k: s.get(k) for k in ("time_id", "t_snapshot") + STAGES + (
                "n_snapshot_bytes", "n_leaves", "n_active_leaves",
                "n_chunks", "n_dirty_chunks", "pods_written",
                "bytes_written", "n_digest_syncs", "n_gather_syncs")})))


def descend(gen, device, card: str) -> None:
    """The train step descends on the card: from a fresh full-width init,
    8 steps of `make_train_step` on one fixed batch at lr 1e-4 must lower
    the loss.  (The trainer's own lr of 1e-3, the reference's, makes the
    full-width loss rise step after step in both packages:
    `experiments/train_trend.py --layers 12`.)"""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import batch_on
    from repro_torch.models.model import init_model_params
    from repro_torch.train.data import TokenPipeline
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    cfg = get_config("qwen1.5-0.5b")
    opt_cfg = OptConfig(lr=1e-4)
    state = init_train_state(cfg, init_model_params(cfg, gen, device=device),
                             opt_cfg)
    step = make_train_step(cfg, opt_cfg, remat=False)
    batch = batch_on(TokenPipeline(cfg.vocab, TRAIN["global_batch"],
                                   TRAIN["seq_len"]).next_batch(), device)
    losses = []
    for _ in range(8):
        state, met = step(state, batch)
        losses.append(float(met["nll"]))
    if not (np.isfinite(losses).all()
            and np.mean(losses[-2:]) < np.mean(losses[:2])):
        raise AssertionError(f"the step did not descend: {losses}")
    log(f"[train] descent ({card}): 8 steps at lr 1e-4 on one fixed batch "
        f"from a fresh init: losses {losses}")
    busy, wall, n_ops = profile_device(lambda: step(state, batch), 2)
    log(f"[trace] full-width train step under the profiler ({card}): device "
        f"busy {busy:.3f} ms of {wall:.3f} ms wall per step "
        f"({100 * busy / wall:.1f}%), {n_ops:.0f} device ops per step")
    del state, step, batch
    torch.cuda.empty_cache()


def phase_train(gen, device, card: str) -> dict:
    """10a-10d: the trainer at full width (see the module docstring,
    phase 10).  Returns K1's launches on the training path and its
    numbers at the training plan."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import LGA, Chipmink, MemoryStore
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.launch.train import batch_on, snapshot_of
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.models.model import init_model_params
    from repro_torch.runtime import TrainingSupervisor
    from repro_torch.train.data import TokenPipeline
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    from repro_torch.train.tree import tree_leaves_with_paths
    launches = 0

    # -- 10a: the trainer, async ----------------------------------------
    a = observe_train(device, **TRAIN)
    launches += a["launches"]
    out = a["out"]
    log_train("10a async", a, card)
    full = out["losses"]
    t0 = time.perf_counter()
    want = snapshot_of(out["state"], out["pipeline"])
    got = out["chipmink"].load()
    torch.cuda.synchronize()
    bit_equal(got, want)
    log(f"[train] 10a: the last commit loads back bit-exact "
        f"({time.perf_counter() - t0:.3f} s)")
    del got
    items = inplace_items(want, TRAIN_CHUNK_BYTES)
    err = check_inplace("training", items, TRAIN_CHUNK_BYTES, gen, device)
    k1 = time_inplace("training", items, TRAIN_CHUNK_BYTES, device)
    k1["max_abs_err"] = err
    if k1["n_rows"] != a["k1_rows"][-1][0]:
        raise AssertionError(f"training plan of {k1['n_rows']} rows, the "
                             f"saves launched K1 over {a['k1_rows']}")
    out["chipmink"].close()
    del a, out, want, items
    torch.cuda.empty_cache()
    descend(gen, device, card)

    # -- 10b: frozen fine-tune ------------------------------------------
    frozen = ("params/embed",) + tuple(f"params/layers/{i}"
                                       for i in range(22))
    b = observe_train(device, frozen=frozen, **TRAIN)
    launches += b["launches"]
    out = b["out"]
    log_train("10b frozen", b, card)
    params = tree_leaves_with_paths({"params": out["state"]["params"]})
    want_ro = {p for p, _ in params
               if any(p == f or p.startswith(f + "/") for f in frozen)}
    if out["readonly"] != want_ro:
        raise AssertionError(f"10b: read-only set of {len(out['readonly'])} "
                             f"leaves, the frozen parameters are "
                             f"{len(want_ro)}")
    boot, second = out["chipmink"].save_stats
    if second["n_active_leaves"] != second["n_leaves"] - len(want_ro):
        raise AssertionError(f"10b: {second['n_active_leaves']} active of "
                             f"{second['n_leaves']} leaves")
    if not second["bytes_written"] < 0.3 * boot["bytes_written"]:
        raise AssertionError(f"10b: second save wrote "
                             f"{second['bytes_written']} bytes, bootstrap "
                             f"{boot['bytes_written']}")
    frozen_rows = sum(-(-leaf.numel() * leaf.element_size()
                        // TRAIN_CHUNK_BYTES)
                      for p, leaf in params if p in want_ro)
    (_, real0), (_, real1) = b["k1_rows"]
    if real0 - real1 != frozen_rows:
        raise AssertionError(f"10b: K1's real rows fell from {real0} to "
                             f"{real1}, the frozen leaves hold {frozen_rows}")
    log(f"[train] 10b: read-only set = the {len(want_ro)} frozen parameter "
        f"leaves; second save {second['n_active_leaves']} of "
        f"{second['n_leaves']} leaves active, {second['bytes_written']} "
        f"bytes ({100 * second['bytes_written'] / boot['bytes_written']:.2f}"
        f"% of the bootstrap's {boot['bytes_written']}); K1's real rows "
        f"{real0} -> {real1} (the frozen leaves hold {frozen_rows})")
    out["chipmink"].close()
    del b, out
    torch.cuda.empty_cache()

    # -- 10c: resume from a commit, against 10a's uninterrupted 8 steps --
    c = observe_train(device, **dict(TRAIN, steps=4, save_every=4,
                                     async_save=False))
    launches += c["launches"]
    log_train("10c 4 steps, sync", c, card)
    cfg = get_config("qwen1.5-0.5b")
    t0 = time.perf_counter()
    loaded = c["out"]["chipmink"].load()
    state = train_state_from_numpy(loaded, device)
    pipe = TokenPipeline(cfg.vocab, TRAIN["global_batch"], TRAIN["seq_len"])
    pipe.restore(loaded["data"])
    t_restore = time.perf_counter() - t0
    first = c["out"]["losses"]
    c["out"]["chipmink"].close()
    del c, loaded
    step = make_train_step(cfg, OptConfig(lr=1e-3), remat=False)
    resumed = []
    for _ in range(4):
        state, met = step(state, batch_on(pipe.next_batch(), device))
        resumed.append(float(met["nll"]))
    np.testing.assert_allclose(first + resumed, full, rtol=1e-4, atol=1e-4)
    log(f"[train] 10c: 4 steps, load of the newest commit and restore "
        f"{t_restore:.3f} s, 4 more: losses {first + resumed} against the "
        f"uninterrupted {full}, within rtol=atol=1e-4; bit-equal: "
        f"{first + resumed == full}")
    del state, step
    torch.cuda.empty_cache()

    # -- 10d: supervisor restart, 2 layers ------------------------------
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    opt_cfg = OptConfig(lr=1e-3)
    state = init_train_state(cfg2, init_model_params(cfg2, gen,
                                                     device=device), opt_cfg)
    pipe = TokenPipeline(cfg2.vocab, TRAIN["global_batch"], TRAIN["seq_len"])
    step = make_train_step(cfg2, opt_cfg, remat=False)
    ck = Chipmink(MemoryStore(), LGA(), chunk_bytes=TRAIN_CHUNK_BYTES,
                  async_mode=True, device=device)
    sup = TrainingSupervisor(ck, save_every=3)

    def do_step(st, i):
        new, _ = step(st, batch_on(pipe.next_batch(), device))
        return new

    def restore(loaded):
        pipe.restore(loaded["data"])
        return train_state_from_numpy(loaded, device)

    fp.reset_launch_counts()
    t0 = time.perf_counter()
    final, stats = sup.run(state, 8, do_step,
                           make_snapshot=lambda st: snapshot_of(st, pipe),
                           restore=restore, fail_at={5})
    wall = time.perf_counter() - t0
    launches += fp.launches["fingerprint_cmp"]
    if not (int(final["step"]) == 8 and stats["failures"] == 1
            and stats["resumed_from"] == [3] and not stats["save_errors"]
            and pipe.cursor()["step"] == 8):
        raise AssertionError(f"10d: step {int(final['step'])}, {stats}, "
                             f"cursor {pipe.cursor()}")
    log(f"[train] 10d ({card}): TrainingSupervisor, 2 layers, 8 steps, "
        f"a failure injected at step 5: {stats}, saves {sup.saves}, ended "
        f"at step 8 with the data cursor at 8, {wall:.3f} s; K1 launches "
        f"{fp.launches['fingerprint_cmp']}")
    ck.close()
    del final, state, ck, sup
    torch.cuda.empty_cache()
    return dict(launches=launches, k1=k1)


# --------------------------------------------------------------------------
# phase 11: the other model families
# --------------------------------------------------------------------------

#: card against CPU: the tolerance of the port's CPU model tests
#: (`tests/test_torch_models.py` TOL, absolute and relative 2e-2, about
#: five bf16 ulps at unit scale).  At full width a few elements in ten
#: thousand pass it by a little: the card's and the CPU's matmuls sum in
#: other orders, flip a bf16 rounding in ~0.2% of outputs, and each flip
#: feeds every later layer (12 in whisper-base).  So 11a holds every
#: element within `MODEL_TOL_ALL` (ten ulps at unit scale) and at least
#: `MODEL_TOL_SHARE` of each tensor's elements within `MODEL_TOL`, and
#: prints the share that is.
MODEL_TOL = dict(rtol=2e-2, atol=2e-2)
MODEL_TOL_ALL = dict(rtol=4e-2, atol=4e-2)
MODEL_TOL_SHARE = 0.999
#: the cache leaves of a recurrent layer, and of them its state (its
#: conv window holds the layer's last 3 inputs, which can repeat: with
#: tied embeddings greedy decoding of random weights echoes the last
#: token, so the window's newest row comes back unchanged)
STATE_LEAVES = ("conv", "ssm", "lru")
STATES = ("ssm", "lru")


def on(tree, device):
    """A copy of a tree of tensors on `device`; tied tensors stay tied."""
    memo = {}

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, torch.Tensor):
            if id(t) not in memo:
                memo[id(t)] = t.to(device)
            return memo[id(t)]
        return t
    return go(tree)


def card_close(card: torch.Tensor, cpu: torch.Tensor, what: str,
               shares: list) -> float:
    """Max abs difference of a card tensor and its CPU twin; raises
    unless every element is within `MODEL_TOL_ALL` and a share of at
    least `MODEL_TOL_SHARE` within `MODEL_TOL` (appended to
    `shares`)."""
    g, w = card.float().cpu(), cpu.float()
    if g.shape != w.shape:
        raise AssertionError(f"{what}: shape {tuple(g.shape)} on the card, "
                             f"{tuple(w.shape)} on the CPU")
    if not g.numel():
        return 0.0
    err = float((g - w).abs().max())
    share = float(torch.isclose(g, w, **MODEL_TOL).float().mean())
    shares.append(share)
    if not torch.allclose(g, w, **MODEL_TOL_ALL) or share < MODEL_TOL_SHARE:
        raise AssertionError(f"{what}: the card and the CPU differ (max abs "
                             f"{err}; {100 * share:.4f}% within {MODEL_TOL},"
                             f" want every element within {MODEL_TOL_ALL} "
                             f"and {100 * MODEL_TOL_SHARE}% within)")
    return err


def sure(ref: torch.Tensor, k: int) -> torch.Tensor:
    """Rows whose k-th and (k+1)-th largest values of `ref` (the CPU's)
    are further apart than twice the tolerance: a choice of the top k
    there cannot flip within it."""
    top = torch.sort(ref.float(), dim=-1, descending=True).values
    tol = MODEL_TOL["atol"] + MODEL_TOL["rtol"] * top[..., k - 1].abs()
    return (top[..., k - 1] - top[..., k]) > 2 * tol


def choices_agree(card: torch.Tensor, cpu: torch.Tensor, k: int,
                  what: str) -> float:
    """The top-k index sets agree on every sure row (`sure`); returns the
    share of rows that are sure."""
    card, cpu = card.float().cpu(), cpu.float()
    ok = sure(cpu, k)
    a = torch.sort(torch.topk(card, k).indices, dim=-1).values[ok]
    b = torch.sort(torch.topk(cpu, k).indices, dim=-1).values[ok]
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: top-{k} choices differ where the "
                             f"margin exceeds the tolerance")
    return float(ok.float().mean()) if ok.numel() else 1.0


def family_numerics(arch: str, gen, device) -> dict:
    """11a: a full-width copy of `arch` (2 layers; 3 for the hybrid, so
    that a local-attention layer is in it; Whisper whole) drawn on the
    card and copied bit for bit to the CPU; 4 decode steps of B=4 on the
    card (under `set_sync_debug_mode("error")`) and on the CPU through
    the port's plain path.  Logits, every cache leaf, Whisper's encoder
    output and the MoE router logits agree as `card_close` asks; greedy
    tokens and MoE expert choices are equal wherever the CPU's margin
    exceeds twice `MODEL_TOL`."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe, whisper
    from repro_torch.models.model import api, init_model_params
    from repro_torch.train.serve_step import make_decode_step
    cfg = get_config(arch)
    if cfg.encoder is None:
        cfg = dataclasses.replace(cfg, n_layers=3 if cfg.rglru else 2)
    m = api(cfg)
    params = init_model_params(cfg, gen, device=device)
    host = on(params, "cpu")
    B, T = FAMILY_SERVE["n_requests"], FAMILY_SERVE["cache_len"]
    caches = {"card": m.init_cache(cfg, B, T, device=device),
              "cpu": m.init_cache(cfg, B, T, device="cpu")}
    rng = np.random.default_rng(17)
    errs = collections.defaultdict(float)
    shares = []
    if cfg.encoder is not None:
        frames = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model))).to(torch.bfloat16)
        enc = whisper.encode(params, frames.to(device), cfg)
        errs["encoder"] = card_close(enc, whisper.encode(host, frames, cfg),
                                     f"{arch} encoder output", shares)
        caches["card"]["cross"] = whisper.build_cross_cache(params, enc, cfg)
        caches["cpu"]["cross"] = on(caches["card"]["cross"], "cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, 4))
                            .astype(np.int32))
    toks_card = toks.to(device)
    routed = {"card": [], "cpu": []}
    side = "card"
    real = moe.router_dispatch

    def spy(logits, mcfg):
        routed[side].append(logits.detach().clone())
        return real(logits, mcfg)

    step = make_decode_step(cfg)
    tokens_sure = []
    moe.router_dispatch = spy
    try:
        for i in range(4):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                side = "card"
                lg, caches["card"] = step(params, caches["card"],
                                          toks_card[:, i:i + 1])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            side = "cpu"
            lc, caches["cpu"] = step(host, caches["cpu"], toks[:, i:i + 1])
            errs["logits"] = max(errs["logits"], card_close(
                lg, lc, f"{arch} step {i} logits", shares))
            tokens_sure.append(choices_agree(lg, lc, 1,
                                             f"{arch} step {i} argmax"))
            for li, lcache in caches["cpu"]["layers"].items():
                for name, want in lcache.items():
                    key = "state" if name in STATE_LEAVES else "kv"
                    errs[key] = max(errs[key], card_close(
                        caches["card"]["layers"][li][name], want,
                        f"{arch} step {i} layer {li} {name}", shares))
    finally:
        moe.router_dispatch = real
    experts_sure = []
    if cfg.moe is not None:
        if len(routed["card"]) != len(routed["cpu"]) or not routed["cpu"]:
            raise AssertionError(f"{arch}: router calls {len(routed['card'])}"
                                 f" on the card, {len(routed['cpu'])} on "
                                 f"the CPU")
        for j, (a, b) in enumerate(zip(routed["card"], routed["cpu"])):
            errs["router"] = max(errs["router"], card_close(
                a, b, f"{arch} router logits {j}", shares))
            experts_sure.append(choices_agree(
                a, b, cfg.moe.top_k, f"{arch} expert choices {j}"))
    copy = ("the whole model" if cfg.encoder is not None
            else f"{cfg.n_layers}-layer copy at full width")
    log(f"[families] 11a {arch}: {copy}, "
        f"4 decode steps of B={B} on the card (no host sync) and on the "
        f"CPU agree: every element within {MODEL_TOL_ALL}, "
        f"{100 * min(shares):.4f}% to {100 * max(shares):.4f}% of each "
        f"tensor's elements within {MODEL_TOL}; max abs errors "
        f"{json.dumps({k: round(v, 6) for k, v in errs.items()})}; greedy "
        f"tokens equal on the {100 * np.mean(tokens_sure):.1f}% of rows "
        f"whose margin exceeds twice the tolerance"
        + (f"; expert choices (top-{cfg.moe.top_k} of "
           f"{cfg.moe.n_experts}) equal on the "
           f"{100 * np.mean(experts_sure):.1f}% sure tokens of "
           f"{len(experts_sure)} router calls" if experts_sure else ""))
    return dict(errs, min_share=min(shares))


def manifest_digests(store, tid: int) -> dict:
    """{leaf key: [16-byte chunk digests]} of a commit's manifest."""
    chunks = store.get_manifest(tid)["chunks"]
    return {k: [bytes(d[i:i + 16]) for i in range(0, len(d), 16)]
            for k, d in chunks.items()}


def family_sessions(arch: str, gen, device) -> dict:
    """11b: `FAMILY_SERVE`'s traffic at full depth through
    `SessionService`, `make_decode_step` and `init_model_params`: every
    commit loads back bit-exact, every fetch is counted (<= 2 per save
    body, none in a decode step), a recurrent family's second save
    dirties every chunk of its SSM or LRU states, Whisper's second
    save writes no pod of its cross K/V; then K1 at this family's plan
    (checked bit-exact against its plain version at the Mamba and
    Whisper plans, and timed)."""
    from repro_torch.configs import get_config
    from repro_torch.core import LGA, MemoryStore
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.models import whisper
    from repro_torch.models.model import api, init_model_params
    from repro_torch.sessions import SessionService
    from repro_torch.train.serve_step import make_decode_step
    cfg = get_config(arch)
    m = api(cfg)
    params = init_model_params(cfg, gen, device=device)
    step = make_decode_step(cfg)
    B, T = FAMILY_SERVE["n_requests"], FAMILY_SERVE["cache_len"]
    n, every = FAMILY_SERVE["n_sessions"], FAMILY_SERVE["save_every"]
    n_tokens = 8 + FAMILY_SERVE["gen_tokens"]
    def new_cache(rng):
        cache = m.init_cache(cfg, B, T, device=device)
        if cfg.encoder is not None:
            frames = torch.from_numpy(rng.standard_normal(
                (B, cfg.encoder.n_frames, cfg.d_model))).to(torch.bfloat16)
            enc = whisper.encode(params, frames.to(device), cfg)
            cache["cross"] = whisper.build_cross_cache(params, enc, cfg)
        return cache

    # one decode step with host syncs turned into errors, then its time
    cache = new_cache(np.random.default_rng(1))
    tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
    logits, cache = step(params, cache, tok)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = step(params, cache, tok)
        tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    finally:
        torch.cuda.set_sync_debug_mode(0)

    def decode():
        nonlocal logits, cache
        logits, cache = step(params, cache, tok)

    decode_ms = [cuda_ms(decode, 10) for _ in range(2)]
    busy, wall, n_ops = profile_device(decode, 3)
    del cache, logits

    # the sessions: prompts and frames drawn as `serve` draws them
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, size=(B, 7)).astype(np.int32)
    prompts, caches = [], []
    for _ in range(n):
        own = rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)
        prompts.append(torch.from_numpy(
            np.concatenate([shared, own], axis=1)).to(device))
        caches.append(new_cache(rng))
    svc = SessionService(MemoryStore(), pool_size=n, policy=LGA(),
                         chunk_bytes=SERVE_CHUNK_BYTES, device=device)
    for k in range(n):
        svc.open_session(f"s{k}")
    toks = [None] * n
    clones, per_save, step_fetches = {}, [], 0
    caller = threading.get_ident()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    fp.reset_launch_counts()
    with FetchesByThread() as fetches:
        for i in range(n_tokens):
            for k in range(n):
                tk = prompts[k][:, i:i + 1] if i < 8 else toks[k]
                f0 = fetches.counts[caller]
                logits, caches[k] = step(params, caches[k], tk)
                toks[k] = torch.argmax(logits, dim=-1, keepdim=True)\
                    .to(torch.int32)
                step_fetches += fetches.counts[caller] - f0
                if (i + 1) % every:
                    continue
                state = {"cache": caches[k], "cursor": {"pos": i + 1}}
                clones_k = snapshot(state)
                f0 = fetches.counts[caller]
                tid = svc.save_session(f"s{k}", state)
                per_save.append((k, tid, fetches.counts[caller] - f0))
                clones[tid] = clones_k
    torch.cuda.synchronize()
    launches = fp.launches["fingerprint_cmp"]
    peak = torch.cuda.max_memory_allocated(device)
    if step_fetches:
        raise AssertionError(f"{arch}: decode steps fetched {step_fetches} "
                             f"times")
    if launches <= 0:
        raise AssertionError(f"{arch}: the session saves launched no K1")
    stats = {s["time_id"]: s for ck in svc.pool for s in ck.save_stats}
    for k, tid, f in per_save:
        body = stats[tid]["n_digest_syncs"] + stats[tid]["n_gather_syncs"]
        if f != body or not 1 <= body <= 2:
            raise AssertionError(f"{arch} save {tid}: {f} fetches, stats "
                                 f"{body}")
    t0 = time.perf_counter()
    for tid, clone in clones.items():
        bit_equal(svc.pool[0].load(time_id=tid), clone)
    t_load = time.perf_counter() - t0
    # the second save of each session against its first, chunk by chunk
    store = svc.store
    by_session = collections.defaultdict(list)
    for k, tid, _ in per_save:
        by_session[k].append(tid)
    checked, conv = 0, [0, 0]
    for k, (t1, t2) in by_session.items():
        d1, d2 = manifest_digests(store, t1), manifest_digests(store, t2)
        for key, digs in d2.items():
            name = key.rsplit("/", 1)[-1]
            same = sum(a == b for a, b in zip(d1[key], digs))
            if name in STATES:
                if same:
                    raise AssertionError(f"{arch} s{k}: {same} of "
                                         f"{len(digs)} chunks of {key} "
                                         f"clean in the second save")
                checked += len(digs)
            elif name == "conv":
                conv[0] += len(digs) - same
                conv[1] += len(digs)
            if key.startswith("cache/cross/"):
                if d1[key] != digs:
                    raise AssertionError(f"{arch} s{k}: {key} changed")
                checked += len(digs)
        if cfg.encoder is not None:
            old = {p["d"] for p in store.get_manifest(t1)["pods"].values()}
            for p in store.get_manifest(t2)["pods"].values():
                if p["d"] in old:
                    continue
                entries = msgpack.unpackb(store.get_pod(p["d"]),
                                          raw=False)["e"]
                if any(e["k"].startswith("cache/cross/") for e in entries):
                    raise AssertionError(f"{arch} s{k}: the second save "
                                         f"rewrote a cross K/V pod")
    ordered = [stats[tid] for _, tid, _ in per_save]
    stalls = list(svc.save_stalls)
    fleet = svc.fleet_stats().as_dict()
    stages = _mean_stages(ordered, stalls)
    what = (f"every chunk of every SSM/LRU state dirty in each second "
            f"save (conv windows: {conv[0]} of {conv[1]} chunks dirty)"
            if cfg.ssm or cfg.rglru else
            "every cross-K/V chunk clean and no cross pod rewritten in each "
            "second save" if cfg.encoder else "")
    log(f"[families] 11b {arch}: decode {decode_ms} ms per step by CUDA "
        f"events (B={B}, 2 runs of 10), no host sync; profiled, the card "
        f"busy {busy:.3f} ms of {wall:.3f} ms wall per step "
        f"({100 * busy / wall:.1f}%), {n_ops:.0f} device ops per step")
    log(f"[families] 11b {arch}: {len(per_save)} saves, fetches per save "
        f"{[f for _, _, f in per_save]}, 0 in {n * n_tokens} decode steps; "
        f"all {len(clones)} commits load back bit-exact ({t_load:.3f} s)"
        + (f"; {what} ({checked} chunks checked)" if what else "")
        + f"; save stall p50 {fleet['p50_save_stall_s'] * 1e3:.3f} ms, "
        f"stalls {[round(t * 1e3, 3) for t in stalls]} ms; bytes written "
        f"per save {[s['bytes_written'] for s in ordered]}; dirty chunks "
        f"{[s['n_dirty_chunks'] for s in ordered]} of "
        f"{ordered[-1]['n_chunks']}; dedup {fleet['dedup_ratio']:.4f}x; "
        f"peak device memory {peak / 1e9:.3f} GB; K1 launches {launches}")
    log(f"[families] 11b {arch}: mean stage times (s; 'untimed' is the "
        f"rest of the stall): {json.dumps(stages)}")
    err = 0
    if cfg.ssm is not None or cfg.encoder is not None:
        items = inplace_items({"cache": caches[0],
                               "cursor": {"pos": n_tokens}},
                              SERVE_CHUNK_BYTES)
        err = check_inplace(f"the {arch} session plan", items,
                            SERVE_CHUNK_BYTES, gen, device)
        del items
    del svc, params, caches, clones, state, store
    torch.cuda.empty_cache()
    return dict(launches=launches, err=err, decode_ms=decode_ms,
                fleet=fleet, peak=peak, stages=stages,
                bytes=[s["bytes_written"] for s in ordered])


def family_serve(arch: str, device) -> int:
    """11c: the entry point once, sync, at full width: 2 snapshots per
    session, K1 launched, the evicted session's bytes reclaimed.  Returns
    K1's launches."""
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.launch.serve import serve
    kw = dict(FAMILY_SERVE)
    torch.cuda.synchronize()
    fp.reset_launch_counts()
    res = serve(arch, reduced=False, device="cuda", log=False, **kw)
    torch.cuda.synchronize()
    launches = fp.launches["fingerprint_cmp"]
    n_snaps = kw["n_sessions"] * (8 + kw["gen_tokens"]) // kw["save_every"]
    if len(res["snap_stats"]) != n_snaps:
        raise AssertionError(f"{arch} serve: {len(res['snap_stats'])} "
                             f"snapshots, want {n_snaps}")
    if launches <= 0:
        raise AssertionError(f"{arch} serve: no K1 launch")
    if not res["evict_stats"].bytes_reclaimed > 0:
        raise AssertionError(f"{arch} serve: eviction reclaimed nothing")
    log(f"[families] 11c {arch}: serve(reduced=False) made {n_snaps} "
        f"snapshots in {res['wall']:.3f} s, K1 launches {launches}, "
        f"eviction reclaimed {res['evict_stats'].bytes_reclaimed} bytes, "
        f"dedup {res['fleet']['dedup_ratio']:.4f}x")
    res["service"].close()
    del res
    torch.cuda.empty_cache()
    return launches


def phase_families(gen, device, k1_by_plan: dict) -> dict:
    """Phase 11 (see the module docstring): 11a, 11b and 11c for each of
    `FAMILY_ARCHS`, one model on the card at a time; K1's times at each
    family's plan come from phase 1 (`k1_by_plan`).  Returns K1's
    launches on the phase's session saves, the largest K1 error, and
    each family's numbers."""
    t0 = time.perf_counter()
    out = dict(launches=0, err=0, by_arch={})
    for arch in FAMILY_ARCHS:
        t1 = time.perf_counter()
        num = family_numerics(arch, gen, device)
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        ses = family_sessions(arch, gen, device)
        t3 = time.perf_counter()
        served = family_serve(arch, device)
        log(f"[families] {arch}: 11a {t2 - t1:.1f} s, 11b {t3 - t2:.1f} s, "
            f"11c {time.perf_counter() - t3:.1f} s")
        out["launches"] += ses["launches"] + served
        out["err"] = max(out["err"], ses["err"])
        out["by_arch"][arch] = dict(numerics=num, sessions=ses)
        k1 = k1_by_plan[arch]
        log(f"[families] {arch}: K1 at its session plan ({k1['n_rows']} "
            f"rows, phase 1): {k1['ms']:.4f} ms per call by CUDA events, "
            f"kernel {k1['device_ms']:.4f} ms by torch.profiler, bound "
            f"{k1['bound_ms']:.4f} ms ({k1['bound_by']}); plain version "
            f"{k1['plain_ms']:.4f} ms; {time.perf_counter() - t1:.1f} s "
            f"for this family")
    log(f"[families] phase 11: {time.perf_counter() - t0:.1f} s wall, K1 "
        f"launched {out['launches']} times on its session saves")
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
    check_param_specs(cfg)
    chunk_bytes = 1 << 22
    main_shapes = bucket_shapes(cfg, chunk_bytes)
    serve_shapes = serving_bucket_shapes()
    small = dict(cfg, layers=2)
    sweep = [(1, 1, 0), (3, 4096, 0), (2, 5000, 0), (7, 1, 0), (64, 128, 0),
             (64, 4096, 0), (1, 1 << 20, 0), (64, 1 << 20, 0), (1, 3, 0),
             (2, 5, 0), (3, 4099, 0), (3, 1 << 20, 0), (149, 1 << 20, 0),
             (70000, 128, 0), (1, 1 << 20, 1), (3, 4096, 2), (5, 1 << 16, 3),
             (9, 4099, 3), (2, 7, 1), (1, 2, 1)]
    # every bucket shape a path gives the kernels: the 24-layer main,
    # async and checkout phases', the 2-layer phases' and serving's
    shapes = list(sweep)
    for C, W in (main_shapes + bucket_shapes(small, chunk_bytes)
                 + serve_shapes):
        if (C, W, 0) not in shapes:
            shapes.append((C, W, 0))
    err = timed("phase 1 (kernels)", phase_kernels, shapes, gen, device)
    log(f"[kernels] main-path bucket shapes {main_shapes}; serving bucket "
        f"shapes {serve_shapes}")
    err_inplace, k1_by_path = timed("phase 1 (in place)", phase_inplace,
                                    cfg, gen, device)
    k1 = k1_by_path["main"]

    main = timed("phase 2", phase_main, cfg, gen, device)
    rung_launches, k2 = timed("phase 3", phase_rungs, small, gen, device)
    timed("phase 4", phase_filestore, small, gen, device)
    timed("phase 5", phase_async, cfg, gen, device)
    timed("phase 6", phase_checkout, cfg, gen, device)
    timed("phase 7", phase_store_features, small, gen, device)
    served = timed("phase 9a", phase_serve, device)
    timed("phase 9b", phase_sessions, gen, device)
    trained = timed("phase 10", phase_train, gen, device,
                    smi.stdout.strip().splitlines()[device.index])
    families = timed("phase 11", phase_families, gen, device, k1_by_path)

    # the main path (phase 2), serving (phase 9a, sync and async),
    # training (phase 10) and the other families' session saves (phase
    # 11b, 11c) run K1; K2 runs on the fused=False and batched=False rungs
    # (phase 3), each read just after its own run.
    serving = {mode: r["launches"]["fingerprint_cmp"]
               for mode, r in served.items()}
    launches = {"fingerprint_cmp": main["launches"]["fingerprint_cmp"]
                + sum(serving.values()) + trained["launches"]
                + families["launches"],
                "fingerprint": rung_launches["fingerprint"]}
    log(f"[numbers] fingerprint_cmp launches: "
        f"{main['launches']['fingerprint_cmp']} on the main path "
        f"({main['launches']['fingerprint_cmp'] / main['n_saves']} per "
        f"save), {serving} serving "
        f"({serving['sync'] / served['sync']['n_saves']} per session save), "
        f"{trained['launches']} training (1 per save), "
        f"{families['launches']} on the other families' session saves")
    kt = trained["k1"]
    log(f"[numbers] fingerprint_cmp at the training plan ({kt['n_rows']} "
        f"rows, 256 KiB chunks): {kt['ms']:.4f} ms per call by CUDA events, "
        f"kernel {kt['device_ms']:.4f} ms by torch.profiler, the wrapper's "
        f"host time {kt['host_ms']:.4f} ms, bound {kt['bound_ms']:.4f} ms "
        f"({kt['bound_by']}), {100 * kt['bound_ms'] / kt['device_ms']:.1f}% "
        f"of the device time; plain version {kt['plain_ms']:.4f} ms; "
        f"bit-exact (max abs err {kt['max_abs_err']})")
    ks = k1_by_path["serving"]
    log(f"[numbers] fingerprint_cmp at the serving plan (buckets "
        f"{serve_shapes}): {ks['ms']:.4f} ms per session save by CUDA "
        f"events, kernel {ks['device_ms']} ms by torch.profiler, bound "
        f"{ks['bound_ms']:.4f} ms ({ks['bound_by']}), "
        f"{100 * ks['bound_ms'] / ks['ms']:.1f}% of the event time; plain "
        f"version {ks['plain_ms']:.4f} ms")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on its path")
    times = {"fingerprint_cmp": k1, "fingerprint": k2}
    where = {"fingerprint_cmp": "over the main path's plan, in place "
                                "(launches: main path, serving, training, "
                                "the other families)",
             "fingerprint": "over one save of each of the fused=False and "
                            "batched=False rungs"}
    k2["max_abs_err"] = max(k2["max_abs_err"], err["fingerprint"])
    k1["max_abs_err"] = max(err["fingerprint_cmp"], err_inplace,
                            trained["k1"]["max_abs_err"], families["err"])
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
            f"kernel device time {t['device_ms']:.4f} ms by torch.profiler; "
            f"no single PyTorch call computes this digest")
    log(smi.stdout.strip().splitlines()[device.index])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
