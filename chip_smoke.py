#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one GPU and check it.

    python3 chip_smoke.py [--seed N] [--layers L]

Phases (each raises on failure; the script then exits non-zero):

  0. Print the card's name and power limit, build the fingerprint kernels
     from `src/repro_torch/csrc/` with nvcc and print the build time and
     the ptxas report.
  1. Hold both kernels against their plain PyTorch versions on the card,
     bit-exact, on a sweep of (C, W) shapes and on every bucket shape of
     phase 2; time K1 (fused digest-and-compare) and its plain version at
     those bucket shapes.
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
     the state, held against the plain version bit-exact, and timed.
  4. A `FileStore` round trip at 2 layers, reopened by a fresh instance.
  5. Numbers: per-save stage times, per-kernel times against their bound.

The line before the last is a JSON object with one entry per kernel; the
last line is the device line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Without a CUDA device, or without the repository's `src/repro_torch`
beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
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


def sparse_round(state: dict, gen: torch.Generator) -> None:
    """Train the last SPARSE_ROWS embedding rows in place; bump the step."""
    for tree, scale in ((state["params"], 0.02),
                        (state["opt"]["mu"], 1e-3),
                        (state["opt"]["nu"], 1e-6)):
        emb = tree["embed"]
        upd = torch.rand((SPARSE_ROWS, emb.shape[1]), generator=gen,
                         device=emb.device) * scale
        emb[-SPARSE_ROWS:] += upd.to(emb.dtype)
    state["step"] += 1


def snapshot(tree):
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.clone()
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


def state_bytes(tree) -> int:
    seen, total = set(), 0

    def walk(t):
        nonlocal total
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.nbytes
    walk(tree)
    return total


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
    """Both kernels vs their plain versions, bit-exact on `shapes`; K1
    and its plain version timed at `timed_shapes` (the main path's
    buckets).  Returns (max abs error per kernel, K1's numbers)."""
    from repro_torch.kernels import fingerprint as fp
    from repro_torch.kernels import ref
    err = {"fingerprint": 0, "fingerprint_cmp": 0}
    k1 = dict(ms=0.0, plain_ms=0.0)
    k2_ms = 0.0                 # K2 at these shapes, for comparison only
    bound = Bound()
    lo, hi = torch.iinfo(torch.int32).min, torch.iinfo(torch.int32).max
    for C, W in shapes:
        words = torch.randint(lo, hi, (C, W), generator=gen, device=device,
                              dtype=torch.int32)
        if (C, W) == (3, 4096):
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
        for name, got, want in (("fingerprint", d2, plain),
                                ("fingerprint_cmp", d1, pd),
                                ("fingerprint_cmp", m1, pm)):
            diff = max_abs_diff(got, want)
            err[name] = max(err[name], diff)
            if diff:
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at (C, W) = ({C}, {W})")
        if not torch.equal(pm, flip.to(torch.int32)):
            raise AssertionError(f"dirty flags wrong at ({C}, {W})")
        if (C, W) in timed_shapes:
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
        log(f"[kernels] (C, W) = ({C}, {W}): K1 and K2 bit-exact with their "
            f"plain versions")
        del words, lengths, plain, prev, d1, d2, m1, pd, pm
    k1.update(bound_ms=bound.ms, bound_by=bound.by)
    log(f"[kernels] at the main path's buckets: K1 {k1['ms']:.4f} ms, K2 "
        f"(which that path does not run) {k2_ms:.4f} ms")
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
    m = dict(ck.store.get_manifest(tid))
    m.pop("stats", None)
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
    out = dict(ms=0.0, plain_ms=0.0, max_abs_err=0)
    bound = Bound()
    for rung, ins in inputs.items():
        for words, lengths in ins:
            diff = max_abs_diff(fp.fingerprint_words(words, lengths),
                                ref.fingerprint_words_ref(words, lengths))
            if diff:
                raise AssertionError(
                    f"fingerprint differs from its plain version on the "
                    f"{rung} rung at {tuple(words.shape)}")
            bound.add(*words.shape, compare=False)
        ms = cuda_ms(lambda: [fp.fingerprint_words(w, n) for w, n in ins], 20)
        plain = cuda_ms(
            lambda: [ref.fingerprint_words_ref(w, n) for w, n in ins], 2)
        out["ms"] += ms
        out["plain_ms"] += plain
        log(f"[rungs] K2 on the {rung} rung's {len(ins)} inputs per save "
            f"{sorted({tuple(w.shape) for w, _ in ins})}: bit-exact with "
            f"the plain version; {ms:.4f} ms per save (plain {plain:.4f} "
            f"ms)")
    out.update(bound_ms=bound.ms, bound_by=bound.by)
    return out


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
    sweep = [(1, 1), (3, 4096), (2, 5000), (7, 1), (64, 128), (64, 4096),
             (1, 1 << 20), (64, 1 << 20)]
    shapes = sweep + [s for s in main_shapes if s not in sweep]
    err, k1 = phase_kernels(shapes, set(main_shapes), gen, device)
    log(f"[kernels] main-path bucket shapes {main_shapes}")

    main = phase_main(cfg, gen, device)
    rung_launches, k2 = phase_rungs(small, gen, device)
    phase_filestore(small, gen, device)

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
            f"no single PyTorch call computes this digest")
    log(smi.stdout.strip().splitlines()[device.index])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
