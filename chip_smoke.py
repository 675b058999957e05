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
     snapshot far smaller than its tip and than its first (by its
     `bytes_written` when sync; by the bytes of the pods it added when
     async, where overlapping bodies each count the others' writes too),
     cross-session dedup > 1, the last
     session evicted with bytes reclaimed, and one CUDA graph built per
     session (`serve` decodes through `compile_decode_step`); prints ms
     per step and stall times, bytes per snapshot, per-stage times of a
     warm save and peak memory.  (b) The compiled step against the eager
     one (`graph_against_eager`): the capture leaves the cache bit-equal,
     8 graphed steps bit-equal to the eager step where two eager runs are
     (else within 11a's rule), decode ms per step both ways by CUDA
     events, the card's busy share and device ops per step under
     torch.profiler, the device memory a graph holds.  Then the same
     traffic through `SessionService`, `compile_decode_step` (one graph
     per session) and
     `init_model_params`, sync and async: every commit loads back bit-exact
     against a clone taken at its `save_session`; fetches counted per
     thread (every save <= 2, exactly 1 where speculation covered the
     dirty chunks, none in the caller of an async save, which runs under
     `torch.cuda.set_sync_debug_mode("error")`); `resume_session` on a
     second service over the same store restores a tip bit-exact, a new
     graph is captured over the restored cache and the next save reuses
     pods; one eager decode step and every capture run under the sync
     debug mode.  (c) K1's time at
     the serving plan against its bound (phase 1's timing).
 10. Training at full width (Qwen1.5-0.5B, 8 x 128 tokens per step, 256
     KiB chunks; 10a and 10c cut to 4 layers, 2.07 GB of train state, to
     keep the script's time; 10b at 24 layers, 4.64 GB), through the entry
     point
     `repro_torch.launch.train.train(..., reduced=False, device="cuda")`,
     which steps through the compiled step (`compile_train_step`: one
     CUDA graph per `train` call, checked to hold one, its capture
     seconds and the device memory it holds printed), each replay timed
     by CUDA events, each `save()` call timed (an async one under
     `set_sync_debug_mode("error")`) and every fetch counted per
     thread.  (a) 8 steps, a save every 4, async: losses finite, the
     last commit loads back bit-exact, 0 fetches in the caller and <= 2
     per save body; then K1 on the training plan (the final state's real
     leaves) bit-exact against its plain version and timed against its
     bound, with its wrapper's host time; then the step must descend: 8
     eager steps at lr 1e-4 on one fixed batch from a fresh init lower
     the loss (at the trainer's lr of 1e-3, the reference's, the
     full-width loss rises step after step, in the reference too:
     `experiments/train_trend.py --layers 12`), and one step runs under
     torch.profiler (device busy share).  (b) The same with the embedding
     and layers 0-21 frozen: the static checker's read-only set is
     exactly the frozen parameters, the second save skips them (active
     leaves, < 30% of the bootstrap's bytes, K1's real rows down by
     theirs), and the graph never wrote them (the same tensors,
     addresses and bits after 8 replays).  (c) 4 steps with a sync save,
     a load of the newest commit, the state rebuilt on the card, the
     cursor restored and a new graph compiled over the rebuilt state, 4
     more: losses within rtol=atol=1e-4 of (a)'s 8.  (d) At 2 layers,
     `TrainingSupervisor` (a save every 3, async) over 8 steps with a
     failure injected at step 5 resumes from the step-3 commit, compiles
     a new graph over the restored state and ends at step 8.  (e) and
     (f) run after (a), before (b)'s commit is kept for phase 12.  (e) The
     24-layer step graphed against eager (`train_graph_against_eager`),
     from one fresh state on 3 equal batches, the runs taking turns on
     the card: the capture (under `set_sync_debug_mode("error")`, as are
     the replays) changes no bit of the state, and after each replay
     params, opt, step and every metric are bit-equal to the eager
     step's where two eager runs are bit-equal to each other, else no
     further from it than twice their own spread; ms per step by CUDA
     events (5 each way), the card's busy ms and ops per step under
     torch.profiler (1 eager, 2 graphed), capture seconds and the device
     memory the graph holds; then the same, once, with remat at 4
     layers.  (f)
     The same check over 3 steps for the other families the trainer
     takes, each at its full published width, one at a time:
     granite-moe-3b-a800m (2 layers; `expert_counts` among the metrics),
     falcon-mamba-7b (2) and recurrentgemma-9b (3, 16.4 GB of train
     state).
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
     every 8 tokens (2 KiB chunks) through `SessionService` and one
     compiled step per session at full depth, after 9b's
     `graph_against_eager` for the family: every commit loads back
     bit-exact, fetches counted (1-2 per
     save, none in a decode step), a recurrent family's second save
     dirties every chunk of its SSM or LRU states, Whisper's second
     save keeps every cross-K/V chunk and rewrites no cross pod;
     stalls, stage times, bytes, dedup, peak memory;
     K1 held bit-exact against its plain version on the live Mamba and
     Whisper session states (its times at each family's plan come from
     phase 1).  (c) `serve(arch,
     reduced=False)` once, sync: 4 snapshots, one CUDA graph per session,
     K1 launched, the evicted session's bytes reclaimed.  Prints the
     phase's wall time, then decode ms per step eager and graphed for
     all six served configurations (phases 9 and 11) and `serve`'s ms
     per step.
 12. Mesh, sharding rules, the dry-run and elastic restore, over
     `torch.distributed`: (c) on a single-rank NCCL group and its (1, 1)
     `make_local_mesh()`, phase 10b's last 24-layer Qwen1.5-0.5B commit
     (`load(names={"params"})`) restored with `elastic_restore` (every
     shard bit-equal to the live parameters, timed), then
     `compressed_psum` over one step's full-width gradients on the mesh's
     ``data`` group, bit-equal to `quantize` then `dequantize`; (a) the
     dry-run (`python -m repro_torch.launch.dryrun`, one fake process
     group per cell in worker processes) of every arch's decode_32k on
     (data=16, model=16) and Qwen1.5-0.5B's train_4k and prefill_32k on
     both production meshes, each cell `ok` with its peak, flops and
     wire bytes per device, and the cells whose peak exceeds the card's
     memory named; (d) meanwhile the four `examples_torch/` scripts on
     the card, each a process that must exit 0 (K1's launches read in
     each); (b) starcoder2-3b decode_32k and falcon-mamba-7b long_500k
     traced on the (1, 1) mesh and run once on the card at full width
     (random parameters, `build_cell` over the NCCL group): the card's
     peak allocation within 15% of the predicted one.

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
#: depth of 10a and 10c (10b trains all 24 layers)
TRAIN_LAYERS = 4
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
    left = mark_and_sweep(ck.store, ck.versions,
                          extra_roots=(ck.lineage.head,), dry_run=True)
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


#: steps of the compiled step against the eager one (9b, 11b)
GRAPH_STEPS = 8


class GraphsBuilt:
    """Counts the compiled decode steps `serve` builds while installed
    (by wrapping `compile_decode_step` in `repro_torch.launch.serve`) and
    checks each holds a captured CUDA graph."""

    def __enter__(self) -> "GraphsBuilt":
        self.mod = importlib.import_module("repro_torch.launch.serve")
        self.real = self.mod.compile_decode_step
        self.graphs = []

        def counted(*args, **kw):
            g = self.real(*args, **kw)
            if g.graph is None:
                raise AssertionError("serve built a decode step with no "
                                     "CUDA graph")
            self.graphs.append(g)
            return g

        self.mod.compile_decode_step = counted
        return self

    def __exit__(self, *exc) -> None:
        self.mod.compile_decode_step = self.real


def compile_strict(cfg, params, cache, device):
    """`compile_decode_step` under `set_sync_debug_mode("error")`, so a
    host sync in the captured step fails the run even where the capture
    alone would not notice it.  The mode is process-wide: call this only
    where no save body is in flight."""
    from repro_torch.train.serve_step import compile_decode_step
    torch.cuda.set_sync_debug_mode("error")
    try:
        return compile_decode_step(cfg, params, cache, device=device)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def graph_against_eager(name: str, cfg, params, make_cache, gen,
                        device) -> dict:
    """One session's compiled step (`compile_decode_step`) against the
    eager step at full width.  The cache, after two eager steps, is
    bit-equal after the capture to what it was before it; then
    `GRAPH_STEPS` steps of equal random tokens through the graph and
    through two eager copies of the cache: logits and every cache leaf
    bit-equal to the eager copy where the two eager runs are bit-equal to
    each other, else within 11a's rule (`card_close`).  Then decode ms
    per step by CUDA events, eager (1 run of 10, to keep the script's
    time) and graphed (2 runs of 10), the card's busy
    share and device ops per step under torch.profiler (3 steps each
    way), the capture's seconds and the device memory the graph holds
    (the reserved bytes it adds: its pool and buffers)."""
    from repro_torch.train.serve_step import make_decode_step
    step = make_decode_step(cfg)
    cache = make_cache()
    B = cache["layers"]["0"][next(iter(cache["layers"]["0"]))].shape[0]
    tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
    for _ in range(2):
        _, cache = step(params, cache, tok)
    copies = [snapshot(cache) for _ in range(2)]
    before = snapshot(cache)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    g = compile_strict(cfg, params, cache, device)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    held = torch.cuda.memory_reserved(device) - reserved
    if g.graph is None:
        raise AssertionError(f"{name}: no CUDA graph captured")
    bit_equal(g.cache, before)
    toks = torch.randint(0, cfg.vocab, (B, GRAPH_STEPS), generator=gen,
                         device=device, dtype=torch.int32)
    stable = bitwise = True
    shares, err, first_diff = [], 0.0, None
    for i in range(GRAPH_STEPS):
        tk = toks[:, i:i + 1]
        outs = []
        for j in range(2):
            lg, copies[j] = step(params, copies[j], tk)
            outs.append(lg)
        got, cache = g(tk)
        here = [(f"step {i} logits", got, outs[0], outs[1]),
                (f"step {i} pos", cache["pos"], copies[0]["pos"],
                 copies[1]["pos"])] + [
            (f"step {i} layer {li} {k}", t, copies[0]["layers"][li][k],
             copies[1]["layers"][li][k])
            for li, lc in cache["layers"].items() for k, t in lc.items()]
        for what, t, a, b in here:
            stable = stable and torch.equal(a, b)
            if not torch.equal(t, a):
                bitwise = False
                first_diff = first_diff or what
                err = max(err, card_close(t, a, f"{name} graph {what}",
                                          shares))
    if stable and not bitwise:
        raise AssertionError(f"{name}: the graph differs from the eager "
                             f"step, which is bit-stable, first at "
                             f"{first_diff}")
    del copies, before
    eager_cache = snapshot(cache)

    def eager():
        nonlocal eager_cache
        _, eager_cache = step(params, eager_cache, tok)

    def graphed():
        g(tok)

    out = dict(capture_s=t_capture, held=held, stable=stable,
               bitwise=bitwise, err=err,
               min_share=min(shares) if shares else 1.0)
    out["eager_ms"] = [cuda_ms(eager, 10)]
    out["graph_ms"] = [cuda_ms(graphed, 10) for _ in range(2)]
    out["eager_prof"] = profile_device(eager, 3)
    out["graph_prof"] = profile_device(graphed, 3)
    verdict = ("bit-equal to the eager step (two eager runs bit-equal)"
               if bitwise and stable else
               "bit-equal to the eager step (two eager runs differ)"
               if bitwise else
               f"within 11a's rule of the eager step, which is not "
               f"bit-stable (max abs {err}, {100 * out['min_share']:.4f}%"
               f" of each tensor within {MODEL_TOL})")
    (eb, ew, eo), (gb, gw, go) = out["eager_prof"], out["graph_prof"]
    log(f"[graph] {name}: the capture ({t_capture:.3f} s, {held} bytes "
        f"of device memory held) left the cache bit-equal; "
        f"{GRAPH_STEPS} graphed steps {verdict}; decode ms per step by "
        f"CUDA events: eager {out['eager_ms']} (1 run of 10), graphed "
        f"{out['graph_ms']} (2 runs of 10); profiled (3 steps), eager: the card busy "
        f"{eb:.3f} ms of {ew:.3f} ms wall ({100 * eb / ew:.1f}%), {eo:.0f} "
        f"device ops per step; graphed: {gb:.3f} ms of {gw:.3f} ms "
        f"({100 * gb / gw:.1f}%; {100 * gb / min(out['graph_ms']):.1f}% "
        f"of the graphed step's event time), {go:.0f} device ops per "
        f"step")
    del g, cache, eager_cache
    torch.cuda.empty_cache()
    return out


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
        with GraphsBuilt() as built:
            res = serve("qwen1.5-0.5b", reduced=False,
                        async_mode=async_mode, device="cuda", log=False,
                        **SERVE)
        torch.cuda.synchronize()
        launches = dict(fp.launches)
        if len(built.graphs) != n:
            raise AssertionError(f"{mode}: serve built {len(built.graphs)} "
                                 f"CUDA graphs for {n} sessions")
        peak = torch.cuda.max_memory_allocated(device)
        svc, snaps, fleet = res["service"], res["snap_stats"], res["fleet"]
        # TimeID order is submission order: round-robin over the sessions
        if len(snaps) != n * n_snaps:
            raise AssertionError(f"{mode}: {len(snaps)} snapshots, want "
                                 f"{n_snaps} per session")
        written = [[s["bytes_written"] for s in snaps[k::n]]
                   for k in range(n)]
        dag = svc.pool[0].versions
        # each snapshot's own new bytes: the pods its commit holds that the
        # session's previous commit did not.  `bytes_written` is the
        # store's growth over a save body, as the reference computes it,
        # so in async mode, where the sessions' bodies overlap, it also
        # counts what the other bodies wrote meanwhile (ROADMAP.md §3):
        # sync mode holds `bytes_written`, async mode the pods' own bytes.
        own = "bytes of pods added" if async_mode else "bytes written"
        delta = []
        for k in range(n - 1):        # the last session was evicted
            ctx = svc.sessions[f"s{k}"]
            head = ctx.lineage.head
            if ctx.n_saves != n_snaps or head != snaps[-n + k]["time_id"]:
                raise AssertionError(f"{mode}: session s{k} made "
                                     f"{ctx.n_saves} saves, head {head}")
            pods = [set(dag.pod_digests_of(s["time_id"]))
                    for s in snaps[k::n]]
            delta.append([sum(svc.store.pod_nbytes(d) for d in p - q)
                          for p, q in zip(pods, [set()] + pods)])
            tip = sum(svc.store.pod_nbytes(d) for d in pods[-1])
            last = (delta if async_mode else written)[k][-1]
            if not last < tip / 4:
                raise AssertionError(f"{mode}: s{k}'s last snapshot: {last} "
                                     f"{own}, a {tip}-byte tip")
        first, *_, last = (delta if async_mode else written)[0]
        if not last < first / 4:
            raise AssertionError(f"{mode}: s0's last snapshot: {last} {own}, "
                                 f"its first {first}")
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
        log(f"[serve] {mode}: {steps} decode steps (one CUDA graph per "
            f"session) and {len(snaps)} snapshots in {res['wall']:.3f} s ({res['wall'] / steps * 1e3:.3f}"
            f" ms per step, saves included); save stall p50 "
            f"{fleet['p50_save_stall_s'] * 1e3:.3f} ms, p99 "
            f"{fleet['p99_save_stall_s'] * 1e3:.3f} ms; dedup "
            f"{fleet['dedup_ratio']:.4f}x ({fleet['logical_tip_bytes']} "
            f"logical / {fleet['physical_tip_bytes']} physical tip bytes); "
            f"evict {fleet['p50_evict_s'] * 1e3:.3f} ms reclaiming "
            f"{res['evict_stats'].bytes_reclaimed} bytes; peak device "
            f"memory {peak / 1e9:.3f} GB; kernel launches {launches}")
        log(f"[serve] {mode}: bytes written per snapshot (the store's "
            f"growth over its body), by session: {written}; bytes of the "
            f"pods each snapshot added to its session's previous commit: "
            f"{delta}; fetches per save body: {dict(fetches)}")
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

    # one decode step with host syncs turned into errors, then the
    # compiled step against it
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

    log(f"[sessions] a full-width decode step (B={B}, {T} cache slots) "
        f"made no host sync under set_sync_debug_mode('error')")
    out["graph"] = graph_against_eager(
        "qwen1.5-0.5b", cfg, params,
        lambda: m.init_cache(cfg, B, T, device=device), gen, device)
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
        steps = [compile_strict(cfg, params, c, device)
                 for c in caches]
        toks = [None] * n
        clones, per_save = {}, []
        caller = threading.get_ident()
        for k in range(n):
            svc.open_session(f"s{k}")
        with FetchesByThread() as fetches:
            for i in range(n_tokens):
                for k in range(n):
                    tok = prompts[k][:, i:i + 1] if i < 8 else toks[k]
                    logits, caches[k] = steps[k](tok)
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
                            tid = svc.sessions["s0"].lineage.head
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
                     for t in ctx.lineage.detector._dev_table.digs)
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
    tip = svc.sessions["s1"].lineage.head
    other = SessionService(svc.store, pool_size=1, **svc_kw)
    t0 = time.perf_counter()
    state = other.resume_session("s1")
    torch.cuda.synchronize()
    t_resume = time.perf_counter() - t0
    bit_equal(state, clones[tip])
    cs = other.sessions["s1"].last_checkout_stats
    # the restored tensors are new: a new graph over them
    resumed = compile_strict(cfg, params, state["cache"], device)
    bit_equal(resumed.cache, clones[tip]["cache"])
    logits, state["cache"] = resumed(toks[1])
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
        f"{cs.n_pods} pods read, {cs.read_bytes} bytes), a graph "
        f"captured over it; the next save made {n_f} fetch(es), reused {s['n_pods_reused']} pods, wrote "
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


def observe_train(device, layers=None, **kw) -> dict:
    """One `repro_torch.launch.train.train("qwen1.5-0.5b", reduced=False,
    device="cuda", **kw)` run (its depth cut to `layers` if given),
    instrumented through the names that module calls: the compiled step
    (`compile_train_step`) checked to hold a CUDA graph, its capture
    seconds and the device memory it holds, each replay timed by CUDA
    events, the checker's seconds, every `save()` call's host time (an
    async one under `set_sync_debug_mode("error")`), K1's row table per
    launch, fetches per thread, K1 launches, peak device memory.  With
    ``frozen`` in `kw`, the frozen leaves of the state the step was
    compiled over are kept (the tensor, its address and a copy of its
    bits) for the caller to check."""
    import dataclasses
    import repro_torch.launch.train as lt
    from repro_torch.kernels import batch as kb
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.train.tree import tree_leaves_with_paths
    real = (lt.Chipmink, lt.compile_train_step, lt.readonly_state_leaves,
            kb.fingerprint_leaves_cmp, lt.get_config)
    obs = dict(events=[], save_calls=[], k1_rows=[], trace_s=None,
               frozen0={})
    frozen = kw.get("frozen", ())

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

    def compile_train_step(step_fn, state, example, **kw):
        obs["frozen0"] = {
            p: (t, t.data_ptr(), t.clone())
            for p, t in tree_leaves_with_paths({"params": state["params"]})
            if any(p == f or p.startswith(f + "/") for f in frozen)}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t = time.perf_counter()
        graph = real[1](step_fn, state, example, **kw)
        torch.cuda.synchronize()
        obs["capture_s"] = time.perf_counter() - t
        obs["held"] = torch.cuda.memory_reserved(device) - reserved
        if graph.graph is None:
            raise AssertionError("train built a step with no CUDA graph")

        def timed(state, batch):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = graph(state, batch)
            ev[1].record()
            obs["events"].append(ev)
            return out
        return timed

    def readonly_state_leaves(*args, **kw):
        t = time.perf_counter()
        try:
            return real[2](*args, **kw)
        finally:
            obs["trace_s"] = time.perf_counter() - t

    def fingerprint_leaves_cmp(leaves, table, *args, **kw):
        obs["k1_rows"].append((table.n_rows, int((table.lengths > 0).sum())))
        return real[3](leaves, table, *args, **kw)

    def get_config(arch):
        cfg = real[4](arch)
        return cfg if layers is None else dataclasses.replace(
            cfg, n_layers=layers)

    (lt.Chipmink, lt.compile_train_step, lt.readonly_state_leaves,
     kb.fingerprint_leaves_cmp, lt.get_config) = (
        Observed, compile_train_step, readonly_state_leaves,
        fingerprint_leaves_cmp, get_config)
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
        (lt.Chipmink, lt.compile_train_step, lt.readonly_state_leaves,
         kb.fingerprint_leaves_cmp, lt.get_config) = real
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
    log(f"[train] {name} ({card}): losses {out['losses']}; graphed step "
        f"ms by CUDA events {obs['step_ms']}; capture {obs['capture_s']:.3f}"
        f" s, {obs['held']} bytes of device memory held by the graph; "
        f"static checker {obs['trace_s']:.3f} s, "
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


#: 10e, 10f: steps of the compiled train step against the eager one
TRAIN_GRAPH_STEPS = 3
#: 10f: the other families the trainer takes (MoE, SSM, hybrid), each at
#: its full published width, cut in depth as phase 11a cuts them
TRAIN_FAMILIES = (("granite-moe-3b-a800m", 2), ("falcon-mamba-7b", 2),
                  ("recurrentgemma-9b", 3))
#: elements per slice when a leaf is compared with a copy on the host
COMPARE_ELEMS = 1 << 26
#: 10e, 10f keep the eager steps' results on the card when all of them
#: take at most this share of its memory, else on the host
RECORDS_ON_CARD = 0.25


def copy_to(flat: list, where) -> dict:
    return {p: t.to(where, copy=True) for p, t in flat}


def leaf_diff(t: torch.Tensor, want: torch.Tensor) -> float:
    """0.0 when a device tensor's bytes equal those of its copy (on the
    card or on the host), else the largest absolute difference of their
    values (-1.0 for a shape or dtype that differs); compared in slices
    of `COMPARE_ELEMS`, so a copy on the host needs little device
    memory."""
    if t.shape != want.shape or t.dtype != want.dtype:
        return -1.0
    a, b, err = t.reshape(-1), want.reshape(-1), 0.0
    for i in range(0, a.numel(), COMPARE_ELEMS):
        x, y = a[i:i + COMPARE_ELEMS], b[i:i + COMPARE_ELEMS].to(t.device)
        if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
            err = max(err, float((x.float() - y.float()).abs().max()),
                      1e-45)
    return err


def train_graph_against_eager(name: str, cfg, device, card: str, *,
                              steps: int = TRAIN_GRAPH_STEPS,
                              remat: bool = False) -> dict:
    """10e, 10f: the compiled train step (`compile_train_step`) against
    the eager one (`make_train_step`), at `cfg` from a fresh init drawn
    from a fixed seed, on `steps` equal batches of `TRAIN`'s shape.  The
    runs take turns on the card, since at full width a graph and an
    eager run of the larger models do not fit it together: (A) the eager
    step, every step's state and metrics copied aside (on the card when
    they take at most `RECORDS_ON_CARD` of it, else on the host); (B) the
    eager step again, each step against A's, then 5 eager steps timed by
    CUDA events and 1 under torch.profiler (its many host-side events
    take the profiler seconds to process); (G) the graph over the same
    fresh state, captured (seconds, the device memory it holds) and
    replayed under `set_sync_debug_mode("error")`: the capture changed no
    bit of the state (parameters as drawn, moments zero, step 0), and
    after each replay every leaf of params, opt and step and every metric
    (`expert_counts` among them) is bit-equal to A's where B is bit-equal
    to A, else no further from A than twice B is, leaf by leaf; then 5
    replays timed by CUDA events and 2 under the profiler."""
    from repro_torch.launch.train import batch_on
    from repro_torch.models.model import init_model_params
    from repro_torch.train.data import TokenPipeline
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (compile_train_step,
                                              init_train_state,
                                              make_train_step)
    from repro_torch.train.tree import tree_leaves_with_paths
    opt_cfg = OptConfig(lr=1e-3)
    step = make_train_step(cfg, opt_cfg, remat=remat)
    pipe = TokenPipeline(cfg.vocab, TRAIN["global_batch"], TRAIN["seq_len"])
    batches = [batch_on(pipe.next_batch(), device) for _ in range(steps)]

    def fresh():
        gen = torch.Generator(device=device).manual_seed(1)
        return init_train_state(
            cfg, init_model_params(cfg, gen, device=device), opt_cfg)

    def flat(state, metrics) -> list:
        return tree_leaves_with_paths({"state": state, "metrics": metrics})

    def diffs(state, metrics, want: dict) -> dict:
        got = flat(state, metrics)
        if sorted(p for p, _ in got) != sorted(want):
            raise AssertionError(f"{name}: the state's or the metrics' "
                                 f"leaves differ from the eager step's")
        return {p: leaf_diff(t, want[p]) for p, t in got}

    t_start = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    held_before = torch.cuda.memory_allocated(device)
    state = fresh()
    state_bytes = sum(t.nbytes for _, t in tree_leaves_with_paths(state))
    aside = device if steps * state_bytes <= RECORDS_ON_CARD * \
        torch.cuda.get_device_properties(device).total_memory else "cpu"
    params0 = copy_to(tree_leaves_with_paths(state["params"]), aside)
    ref = []
    for b in batches:
        state, met = step(state, b)
        ref.append(copy_to(flat(state, met), aside))
    del state, met
    # the largest state fills the card: A's cached blocks, split by its
    # last step, would not hold B's
    torch.cuda.empty_cache()
    t_a = time.perf_counter()
    state, spread = fresh(), []
    for b, want in zip(batches, ref):
        state, met = step(state, b)
        spread.append(diffs(state, met, want))
    t_b = time.perf_counter()
    stable = not any(e for d in spread for e in d.values())
    if any(e < 0 for d in spread for e in d.values()):
        raise AssertionError(f"{name}: two eager runs differ in shape")
    out = dict(stable=stable, eager_ms=cuda_ms(lambda: step(state,
                                                            batches[0]), 5),
               eager_prof=profile_device(lambda: step(state, batches[0]), 1),
               peak_eager=torch.cuda.max_memory_allocated(device))
    del state, met
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)

    state = fresh()
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g = compile_train_step(step, state, batches[0], device=device)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out.update(capture_s=time.perf_counter() - t0,
               held=torch.cuda.memory_reserved(device) - reserved)
    t_timed = t0
    if g.graph is None:
        raise AssertionError(f"{name}: no CUDA graph captured")
    for p, t in tree_leaves_with_paths(state):
        if p.startswith("params/"):
            ok = leaf_diff(t, params0[p[len("params/"):]]) == 0.0
        else:
            ok = not bool(t.any())
        if not ok:
            raise AssertionError(f"{name}: the capture changed {p}")
    err, first_diff = 0.0, None
    for i, (b, want) in enumerate(zip(batches, ref)):
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, met = g(state, b)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if got is not state:
            raise AssertionError(f"{name}: the graph handed back another "
                                 f"state")
        for p, e in diffs(state, met, want).items():
            if e and stable:
                raise AssertionError(f"{name}: step {i} {p} differs from "
                                     f"the eager step (max abs {e}), which "
                                     f"is bit-stable")
            if e and not 0 <= e <= 2 * spread[i][p]:
                raise AssertionError(f"{name}: step {i} {p} is {e} from "
                                     f"the eager step, beyond twice its own "
                                     f"spread {spread[i][p]}")
            if e:
                err, first_diff = max(err, e), first_diff or f"step {i} {p}"
    t_g = time.perf_counter()
    out.update(bitwise=not err, err=err,
               graph_ms=cuda_ms(lambda: g(state, batches[0]), 5),
               graph_prof=profile_device(lambda: g(state, batches[0]), 2),
               peak_graph=torch.cuda.max_memory_allocated(device),
               wall=time.perf_counter() - t_start)
    verdict = ("bit-equal to the eager step (two eager runs bit-equal)"
               if out["bitwise"] and stable else
               "bit-equal to the eager step (two eager runs differ)"
               if out["bitwise"] else
               f"within twice the eager step's own spread (max abs {err}, "
               f"first at {first_diff})")
    (eb, ew, eo), (gb, gw, go) = out["eager_prof"], out["graph_prof"]
    log(f"[train-graph] {name} ({card}; {cfg.n_layers} layers, "
        f"{state_bytes / 1e9:.3f} GB of train state; "
        f"{held_before / 1e9:.3f} GB held by earlier phases): the capture "
        f"({out['capture_s']:.3f} s, {out['held']} bytes of device memory "
        f"held) changed no bit of the state; {steps} graphed steps "
        f"{verdict}; ms per step by CUDA events (5 steps): eager "
        f"{out['eager_ms']:.3f}, graphed {out['graph_ms']:.3f}; profiled (1 "
        f"step eager, 2 graphed), eager: the card busy {eb:.3f} ms of "
        f"{ew:.3f} ms wall ({100 * eb / ew:.1f}%), {eo:.0f} device ops per step; graphed: "
        f"{gb:.3f} ms of {gw:.3f} ms ({100 * gb / gw:.1f}%; "
        f"{100 * gb / out['graph_ms']:.1f}% of the graphed event time), "
        f"{go:.0f} device ops per step; peak device memory eager "
        f"{out['peak_eager'] / 1e9:.3f} GB, graphed "
        f"{out['peak_graph'] / 1e9:.3f} GB; {out['wall']:.1f} s (A "
        f"{t_a - t_start:.1f}, B {t_b - t_a:.1f}, eager timed "
        f"{t_timed - t_b:.1f}, G {t_g - t_timed:.1f}, graph timed "
        f"{out['wall'] - (t_g - t_start):.1f}; the eager results kept on "
        f"{aside})")
    del g, state, met, got, ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


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
    from repro_torch.train.train_step import (compile_train_step,
                                              init_train_state,
                                              make_train_step)
    from repro_torch.train.tree import tree_leaves_with_paths
    launches = 0

    # -- 10a: the trainer, async ----------------------------------------
    a = observe_train(device, layers=TRAIN_LAYERS, **TRAIN)
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

    # -- 10e, 10f: the compiled step against the eager one, before 10b's
    # commit (and its 4.64 GB snapshot buffer) is kept for phase 12 -----
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                              n_layers=TRAIN_LAYERS)
    graphed = {"qwen1.5-0.5b": train_graph_against_eager(
        "qwen1.5-0.5b", get_config("qwen1.5-0.5b"), device, card)}
    train_graph_against_eager(
        f"qwen1.5-0.5b remat, {TRAIN_LAYERS} layers", cfg, device, card,
        steps=1, remat=True)
    for arch, n_layers in TRAIN_FAMILIES:
        graphed[arch] = train_graph_against_eager(
            arch, dataclasses.replace(get_config(arch), n_layers=n_layers),
            device, card)
    log("[numbers] train ms per step by CUDA events, eager -> graphed, "
        "the card's busy ms per graphed step (torch.profiler) and its "
        "share of the graphed event time, capture s, MB a graph holds: "
        + json.dumps({a: [r["eager_ms"], r["graph_ms"], r["graph_prof"][0],
                          round(100 * r["graph_prof"][0] / r["graph_ms"], 1),
                          round(r["capture_s"], 3), round(r["held"] / 1e6, 1),
                          "bit-equal" if r["bitwise"] else
                          f"max abs {r['err']}"]
                      for a, r in graphed.items()}))

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
    if sorted(b["frozen0"]) != sorted(want_ro):
        raise AssertionError("10b: the compiled step's frozen leaves are "
                             "not the frozen parameters")
    live = dict(params)
    for p, (t, ptr, bits) in b["frozen0"].items():
        if not (live[p] is t and t.data_ptr() == ptr
                and torch.equal(t.view(torch.uint8), bits.view(torch.uint8))):
            raise AssertionError(f"10b: frozen leaf {p} was written")
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
        f"{real0} -> {real1} (the frozen leaves hold {frozen_rows}); the "
        f"graph never wrote them (same tensors, addresses and bits after 8 "
        f"replays)")
    # phase 10's last 24-layer commit: its Chipmink and live parameters
    # stay for phase 12c's restore
    commit = dict(ck=out["chipmink"], live=out["state"]["params"])
    del b, out, params
    torch.cuda.empty_cache()

    # -- 10c: resume from a commit, against 10a's uninterrupted 8 steps --
    c = observe_train(device, layers=TRAIN_LAYERS,
                      **dict(TRAIN, steps=4, save_every=4,
                             async_save=False))
    launches += c["launches"]
    log_train("10c 4 steps, sync", c, card)
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                              n_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    loaded = c["out"]["chipmink"].load()
    state = train_state_from_numpy(loaded, device)
    pipe = TokenPipeline(cfg.vocab, TRAIN["global_batch"], TRAIN["seq_len"])
    pipe.restore(loaded["data"])
    t_restore = time.perf_counter() - t0
    first = c["out"]["losses"]
    c["out"]["chipmink"].close()
    del c, loaded
    step_fn = make_train_step(cfg, OptConfig(lr=1e-3), remat=False)
    batches = [batch_on(pipe.next_batch(), device) for _ in range(4)]
    # the rebuilt state holds new tensors: a new graph over them
    step = compile_train_step(step_fn, state, batches[0], device=device)
    if step.graph is None:
        raise AssertionError("10c: no CUDA graph captured")
    resumed = []
    for batch in batches:
        state, met = step(state, batch)
        resumed.append(float(met["nll"]))
    np.testing.assert_allclose(first + resumed, full, rtol=1e-4, atol=1e-4)
    log(f"[train] 10c: 4 steps, load of the newest commit and restore "
        f"{t_restore:.3f} s, a new graph over the restored state, 4 more: "
        f"losses {first + resumed} against the "
        f"uninterrupted {full}, within rtol=atol=1e-4; bit-equal: "
        f"{first + resumed == full}")
    del state, step, step_fn, batches
    torch.cuda.empty_cache()

    # -- 10d: supervisor restart, 2 layers ------------------------------
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    opt_cfg = OptConfig(lr=1e-3)
    state = init_train_state(cfg2, init_model_params(cfg2, gen,
                                                     device=device), opt_cfg)
    pipe = TokenPipeline(cfg2.vocab, TRAIN["global_batch"], TRAIN["seq_len"])
    step_fn = make_train_step(cfg2, opt_cfg, remat=False)
    ck = Chipmink(MemoryStore(), LGA(), chunk_bytes=TRAIN_CHUNK_BYTES,
                  async_mode=True, device=device)
    sup = TrainingSupervisor(ck, save_every=3)
    graphs = []

    def do_step(st, i):
        batch = batch_on(pipe.next_batch(), device)
        # a restore hands back new tensors: a new graph over them
        if not graphs or st is not graphs[-1].state:
            graphs.append(compile_train_step(step_fn, st, batch,
                                             device=device))
        new, _ = graphs[-1](st, batch)
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
            and pipe.cursor()["step"] == 8 and len(graphs) == 2
            and all(g.graph is not None for g in graphs)):
        raise AssertionError(f"10d: step {int(final['step'])}, {stats}, "
                             f"cursor {pipe.cursor()}")
    log(f"[train] 10d ({card}): TrainingSupervisor, 2 layers, 8 steps, "
        f"a failure injected at step 5: {stats}, saves {sup.saves}, ended "
        f"at step 8 with the data cursor at 8, a new graph after the "
        f"restore ({len(graphs)} captured), {wall:.3f} s; K1 launches "
        f"{fp.launches['fingerprint_cmp']}")
    ck.close()
    del final, state, ck, sup, graphs
    torch.cuda.empty_cache()

    return dict(launches=launches, k1=k1, commit=commit)


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

    def spy(logits, mcfg, *rest):
        routed[side].append(logits.detach().clone())
        return real(logits, mcfg, *rest)

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
    """11b: the compiled step against the eager one
    (`graph_against_eager`), then `FAMILY_SERVE`'s traffic at full depth
    through `SessionService`, `compile_decode_step` (one graph per
    session) and `init_model_params`: every
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

    # one decode step with host syncs turned into errors, then the
    # compiled step against it
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

    del cache, logits
    graph = graph_against_eager(arch, cfg, params,
                                lambda: new_cache(np.random.default_rng(1)),
                                gen, device)

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
    steps = [compile_strict(cfg, params, c, device)
             for c in caches]
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
                logits, caches[k] = steps[k](tk)
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
    log(f"[families] 11b {arch}: {len(per_save)} saves, fetches per save "
        f"{[f for _, _, f in per_save]}, 0 in {n * n_tokens} graphed "
        f"decode steps; "
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
    return dict(launches=launches, err=err, graph=graph,
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
    with GraphsBuilt() as built:
        res = serve(arch, reduced=False, device="cuda", log=False, **kw)
    torch.cuda.synchronize()
    launches = fp.launches["fingerprint_cmp"]
    if len(built.graphs) != kw["n_sessions"]:
        raise AssertionError(f"{arch} serve: {len(built.graphs)} CUDA "
                             f"graphs for {kw['n_sessions']} sessions")
    steps = kw["n_sessions"] * (8 + kw["gen_tokens"])
    n_snaps = steps // kw["save_every"]
    if len(res["snap_stats"]) != n_snaps:
        raise AssertionError(f"{arch} serve: {len(res['snap_stats'])} "
                             f"snapshots, want {n_snaps}")
    if launches <= 0:
        raise AssertionError(f"{arch} serve: no K1 launch")
    if not res["evict_stats"].bytes_reclaimed > 0:
        raise AssertionError(f"{arch} serve: eviction reclaimed nothing")
    log(f"[families] 11c {arch}: serve(reduced=False), one CUDA graph "
        f"per session, made {n_snaps} snapshots in {res['wall']:.3f} s "
        f"({res['wall'] / steps * 1e3:.3f} ms per step, saves "
        f"included), K1 launches {launches}, "
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

# --------------------------------------------------------------------------
# phase 12: mesh, sharding rules, the dry-run, elastic restore, examples
# --------------------------------------------------------------------------

#: 12b: cells traced on one card's (1, 1) mesh and then run on the card
DRYRUN_ON_CARD = (("starcoder2-3b", "decode_32k"),
                  ("falcon-mamba-7b", "long_500k"))
#: 12b: largest relative gap of the measured peak from the predicted one
PEAK_TOL = 0.15
#: 12a's dry-run processes (each traces one cell; the host has 8 cores)
DRYRUN_JOBS = 8
EXAMPLES = ("quickstart.py", "branch_and_timetravel.py",
            "incremental_serving.py", "elastic_restart.py")


def dryrun_cells() -> list:
    """12a's cells and 12b's, as `repro_torch.launch.dryrun --cells`
    names them: every arch's decode_32k on (data=16, model=16),
    Qwen1.5-0.5B's train_4k and prefill_32k on both production meshes,
    and 12b's cells on one card's (1, 1) mesh."""
    from repro_torch.configs import ARCHS
    cells = [f"{a}:decode_32k:pod16x16" for a in ARCHS]
    cells += [f"qwen1.5-0.5b:{s}:{m}" for s in ("train_4k", "prefill_32k")
              for m in ("pod16x16", "pod2x16x16")]
    return cells + [f"{a}:{s}:local1x1" for a, s in DRYRUN_ON_CARD]


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def src_env() -> dict:
    import os
    return dict(os.environ, PYTHONPATH=str(REPO / "src"))


def peak_on_card(arch: str, shape: str, mesh, gen, device) -> int:
    """12b: `build_cell` on one card's mesh, the step run once on random
    parameters at full width: the card's peak allocation less what was
    allocated before its arguments."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.parallel.sharding import set_active_mesh
    cfg = get_config(arch)
    set_active_mesh(mesh)
    try:
        step, args_abs, shardings = dryrun.build_cell(arch, shape, mesh)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        args = dryrun.concrete_args(cfg, SHAPES[shape].kind, args_abs,
                                    shardings, gen, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with implicit_replication():
            out = step(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        log(f"[dryrun] 12b {arch} {shape}: the step on the card in "
            f"{time.perf_counter() - t:.3f} s")
        del out, args
    finally:
        set_active_mesh(None)
    torch.cuda.empty_cache()
    return peak


def restore_and_psum(commit: dict, mesh, device) -> dict:
    """12c: phase 10's last 24-layer commit restored onto the mesh,
    every shard bit-equal to the live parameters; then `compressed_psum`
    over one step's full-width gradients, bit-equal to `quantize` then
    `dequantize` (on one rank the sum is the payload itself)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import batch_on
    from repro_torch.models.model import api, model_logical_axes
    from repro_torch.runtime.fault_tolerance import elastic_restore
    from repro_torch.train.data import TokenPipeline
    from repro_torch.train.grad_compress import (compressed_psum,
                                                 dequantize, quantize)
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.train.tree import tree_leaves, tree_map
    cfg = get_config("qwen1.5-0.5b")
    ck, live = commit["ck"], commit["live"]
    t0 = time.perf_counter()
    loaded = ck.load(names={"params"})["params"]
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = elastic_restore(loaded, mesh, model_logical_axes(cfg))
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    bit_equal(tree_map(lambda d: d.to_local(), restored), live)
    n_leaves = len(tree_leaves(restored))
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(live))
    log(f"[restore] 12c: the 24-layer commit ({n_leaves} leaves, {n_bytes} "
        f"bytes) loaded in {t_load:.3f} s, restored onto "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} in {t_restore:.3f} s;"
        f" every shard bit-equal to the live parameters")
    ck.close()
    del restored, loaded
    pipe = TokenPipeline(cfg.vocab, TRAIN["global_batch"], TRAIN["seq_len"])
    grad_fn = value_and_grad(lambda p, b: api(cfg).loss_fn(p, b, cfg,
                                                           remat=False))
    _, grads = grad_fn(live, batch_on(pipe.next_batch(), device))
    group = mesh.get_group("data")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summed = tree_map(lambda g: compressed_psum(g, group), grads)
    torch.cuda.synchronize()
    t_psum = time.perf_counter() - t0
    want = tree_map(lambda g: dequantize(*quantize(g), g.shape, g.dtype),
                    grads)
    bit_equal(summed, want)
    log(f"[restore] 12c: compressed_psum over the {len(tree_leaves(grads))} "
        f"full-width gradient leaves in {t_psum:.3f} s on the single-rank "
        f"group, bit-equal to quantize -> dequantize")
    del grads, summed, want
    torch.cuda.empty_cache()
    return dict(restore_s=t_restore, load_s=t_load, psum_s=t_psum,
                n_bytes=n_bytes)


_EXAMPLE_RUNNER = """
import runpy, sys
path = sys.argv[1]
sys.argv = [path]
runpy.run_path(path, run_name="__main__")
from repro_torch.kernels import fingerprint as fp
print("K1_LAUNCHES", fp.launches["fingerprint_cmp"])
"""


def run_examples() -> int:
    """12d: the four examples on the card at once, each a process of its
    own running the script with its defaults; each must exit 0.  Returns
    K1's launches in them (read from each process after its script)."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", _EXAMPLE_RUNNER,
         str(REPO / "examples_torch" / name)], cwd=REPO, env=src_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in EXAMPLES}
    launches = 0
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"12d: {name} exited {proc.returncode}: "
                                 f"{err[-2000:]}")
        n = int(out.split("K1_LAUNCHES")[-1])
        launches += n
        last = [l for l in out.splitlines() if l.strip()][-2]
        log(f"[examples] 12d {name}: exit 0 at "
            f"{time.perf_counter() - t0:.1f} s, K1 launched {n} times; "
            f"{last[:160]}")
    return launches


def phase_mesh(commit: dict, gen, device) -> dict:
    """Phase 12 (see the module docstring): 12c on a single-rank NCCL
    group; then the dry-run of 12a's and 12b's cells runs in worker
    processes while 12d's examples run; then 12b holds two cells'
    predicted peaks against the card.  Returns K1's launches in the
    examples and the phase's numbers."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    t0 = time.perf_counter()
    cells = dryrun_cells()
    for cell in cells:     # results of an earlier run must not stand in
        (Path(dryrun.ARTIFACT_DIR) / ("__".join(cell.split(":"))
                                      + ".json")).unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    traced = None
    try:
        mesh = make_local_mesh(device_type="cuda")
        restored = restore_and_psum(commit, mesh, device)
        t_dryrun = time.perf_counter()
        traced = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
             ",".join(cells), "--jobs", str(DRYRUN_JOBS), "--device-type",
             "cuda"], cwd=REPO, env=src_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        t_examples = time.perf_counter()
        launches = run_examples()
        t_examples = time.perf_counter() - t_examples
        out, err = traced.communicate(timeout=900)
        t_dryrun = time.perf_counter() - t_dryrun
        results = {}
        for cell in cells:
            path = Path(dryrun.ARTIFACT_DIR) / \
                ("__".join(cell.split(":")) + ".json")
            if not path.exists():
                raise AssertionError(f"12a: no result for {cell}: "
                                     f"{err[-3000:]}")
            results[cell] = r = json.loads(path.read_text())
            log(f"[dryrun] {cell}: ok={r['ok']} trace {r['compile_s']:.1f} "
                f"s, peak {r['peak_bytes_per_device'] / 2**30:.3f} GiB per "
                f"device, {r['flops_per_device']:.4e} flops per device, "
                f"{r['bytes_per_device']:.4e} bytes per device, wire "
                f"{r['collective_wire_bytes'] / 2**20:.1f} MiB in "
                f"{r['n_collectives']} collectives {r['collectives']}"
                + ("" if r["ok"] else f"; error {r['error']}"))
        bad = [c for c, r in results.items() if not r["ok"]]
        if bad or traced.returncode != 0:
            raise AssertionError(f"12a: cells not ok: {bad}; exit "
                                 f"{traced.returncode}")
        total = torch.cuda.get_device_properties(device).total_memory
        over = [c for c, r in results.items()
                if r["peak_bytes_per_device"] > total]
        log(f"[dryrun] 12a: {len(cells)} cells ok in {t_dryrun:.1f} s wall "
            f"({DRYRUN_JOBS} processes); predicted peak above the card's "
            f"{total} bytes: {over or 'none'}")
        peaks = {}
        for arch, shape in DRYRUN_ON_CARD:
            want = results[f"{arch}:{shape}:local1x1"][
                "peak_bytes_per_device"]
            got = peak_on_card(arch, shape, mesh, gen, device)
            gap = got / want - 1
            log(f"[dryrun] 12b {arch} {shape} on (data=1, model=1): "
                f"predicted peak {want} bytes, measured on the card {got} "
                f"bytes ({100 * gap:+.2f}%)")
            if abs(gap) > PEAK_TOL:
                raise AssertionError(f"12b: {arch} {shape} peak {got} is "
                                     f"{100 * gap:+.1f}% off the predicted "
                                     f"{want}")
            peaks[(arch, shape)] = (want, got)
    finally:
        if traced is not None and traced.poll() is None:
            traced.kill()
        dist.destroy_process_group()
    log(f"[mesh] phase 12: {time.perf_counter() - t0:.1f} s wall (dry-run "
        f"{t_dryrun:.1f} s, examples {t_examples:.1f} s)")
    return dict(launches=launches, restored=restored, peaks=peaks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=QWEN1_5_0_5B["layers"],
                    help="depth of the main-path state (full width always)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
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
    sessions = timed("phase 9b", phase_sessions, gen, device)
    trained = timed("phase 10", phase_train, gen, device,
                    smi.stdout.strip().splitlines()[device.index])
    families = timed("phase 11", phase_families, gen, device, k1_by_path)
    graphs = {"qwen1.5-0.5b": sessions["graph"]}
    graphs.update((a, r["sessions"]["graph"])
                  for a, r in families["by_arch"].items())
    log("[numbers] decode ms per step by CUDA events, eager -> graphed, "
        "the card's busy ms per graphed step (torch.profiler) and its "
        "share of the graphed event time: " + json.dumps({
            a: [min(r["eager_ms"]), min(r["graph_ms"]), r["graph_prof"][0],
                round(100 * r["graph_prof"][0] / min(r["graph_ms"]), 1),
                "bit-equal" if r["bitwise"] else
                f"max abs {r['err']}"] for a, r in graphs.items()})
        + "; serve ms per step, saves included (phase 9a): " + json.dumps(
            {mode: r["wall"] / r["steps"] * 1e3
             for mode, r in served.items()}))
    fp.reset_launch_counts()
    meshed = timed("phase 12", phase_mesh, trained.pop("commit"), gen,
                   device)
    meshed["launches"] += fp.launches["fingerprint_cmp"]
    if meshed["launches"] <= 0:
        raise AssertionError("phase 12: K1 never launched")

    # the main path (phase 2), serving (phase 9a, sync and async),
    # training (phase 10) and the other families' session saves (phase
    # 11b, 11c) run K1; K2 runs on the fused=False and batched=False rungs
    # (phase 3), each read just after its own run.
    serving = {mode: r["launches"]["fingerprint_cmp"]
               for mode, r in served.items()}
    launches = {"fingerprint_cmp": main["launches"]["fingerprint_cmp"]
                + sum(serving.values()) + trained["launches"]
                + families["launches"] + meshed["launches"],
                "fingerprint": rung_launches["fingerprint"]}
    log(f"[numbers] fingerprint_cmp launches: "
        f"{main['launches']['fingerprint_cmp']} on the main path "
        f"({main['launches']['fingerprint_cmp'] / main['n_saves']} per "
        f"save), {serving} serving "
        f"({serving['sync'] / served['sync']['n_saves']} per session save), "
        f"{trained['launches']} training (1 per save), "
        f"{families['launches']} on the other families' session saves, "
        f"{meshed['launches']} in phase 12's examples")
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
    log(f"[time] all phases: {time.perf_counter() - t_start:.1f} s")
    log(smi.stdout.strip().splitlines()[device.index])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
