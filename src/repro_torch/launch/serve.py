"""Serving driver: batched request decoding with multi-session
incremental persistence over one shared store.  The port of
`repro.launch.serve`, for every model family.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --reduced --sessions 4 --store memory [--device cpu]

Serving state (KV caches / SSM and LRU states + request cursors) is a
massive, evolving object graph: between snapshots only the cache slots
written since the last save change, so session checkpoints cost O(delta),
not O(cache).  A recurrent state is rewritten whole at every step (every
chunk dirty), and an encoder's cross K/V is written once per session and
reused by every later snapshot.

The driver runs ``n_sessions`` concurrent sessions through one
`repro_torch.sessions.SessionService`: each session is a branch in the
shared store, sessions share their prompt prefix (system prompts,
few-shot headers), so their caches dedup pod-for-pod at the
content-addressed layer, and the per-session incremental pipeline keeps
every later snapshot O(tokens since last snapshot).  At the end an idle
session is evicted to exercise the O(delta) refcount reclaim.

Everything runs on ``device`` (``"cuda"`` by default; it raises without
a card).  Each session decodes through its own compiled step
(`train.serve_step.compile_decode_step`, where the reference jits the
step): on a card one CUDA graph per session, captured once its cache is
built, replayed at every token; a failed capture raises.  Decode updates
the caches and states in place; a sync save digests them before the
next step writes, and an async save snapshots them on the current
stream, which the next replay follows.  Generated tokens stay on the
device and come to the host once, at the end.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config
from ..core import LGA, FileStore, MemoryStore
from ..models import whisper
from ..models.model import api, init_model_params
from ..sessions import SessionService
from ..train.serve_step import compile_decode_step


def _make_store(store: str, store_dir: Optional[str]):
    if store == "memory":
        return MemoryStore()
    if store == "file":
        root = store_dir or tempfile.mkdtemp(prefix="chipmink_serve_")
        return FileStore(root)
    raise ValueError(f"unknown store backend {store!r}")


def serve(arch: str, *, n_requests: int = 4, gen_tokens: int = 32,
          cache_len: int = 128, save_every: int = 8,
          reduced: bool = True, log: bool = True,
          n_sessions: int = 1, store: str = "memory",
          store_dir: Optional[str] = None, async_mode: bool = False,
          evict_last: bool = True, device: Any = "cuda") -> Dict:
    """Decode ``gen_tokens`` tokens for ``n_sessions`` sessions of
    ``n_requests`` requests each, snapshotting every session every
    ``save_every`` tokens onto its own branch of one shared store.
    Returns tokens, per-snapshot stats (TimeID order), the service, and
    the fleet roll-up (dedup ratio, save-stall percentiles)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    m = api(cfg)
    svc = SessionService(
        _make_store(store, store_dir),
        # one pool slot per session (capped) avoids rebind drains in the
        # round-robin save loop below
        pool_size=min(max(1, n_sessions), 4),
        policy=LGA(),
        # fine chunks: ring-buffer KV writes between snapshots touch only
        # a few slots, and flat-range chunks isolate them
        chunk_bytes=1 << 11,
        async_mode=async_mode,
        device=device)
    device = svc.pool[0].device
    params = init_model_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)

    rng = np.random.default_rng(0)
    # all sessions share the first 7 prompt tokens (the fleet's common
    # prefix); the 8th is per-session, so caches diverge from there.
    shared = rng.integers(0, cfg.vocab, size=(n_requests, 7)).astype(np.int32)

    class Sess:
        pass

    sessions: List[Sess] = []
    for s in range(n_sessions):
        svc.open_session(f"s{s}")
        sess = Sess()
        own = rng.integers(0, cfg.vocab, size=(n_requests, 1)).astype(np.int32)
        sess.prompts = torch.from_numpy(
            np.concatenate([shared, own], axis=1)).to(device)
        sess.cache = m.init_cache(cfg, n_requests, cache_len, device=device)
        if cfg.family == "encdec":
            # float64 draws -> float32 -> bf16 on the host, as the
            # reference's `jnp.asarray(..., jnp.bfloat16)` rounds them
            frames = torch.from_numpy(rng.standard_normal(
                (n_requests, cfg.encoder.n_frames, cfg.d_model))) \
                .to(torch.bfloat16)
            enc = whisper.encode(params, frames.to(device), cfg)
            sess.cache["cross"] = whisper.build_cross_cache(params, enc, cfg)
        # each session its own graph and logits buffer: the round-robin
        # below keeps every session's logits until its next step
        sess.step = compile_decode_step(cfg, params, sess.cache,
                                        device=device)
        sess.logits = None
        sess.generated = []
        sessions.append(sess)

    t0 = time.time()
    total = sessions[0].prompts.shape[1] + gen_tokens
    for i in range(total):
        for s, sess in enumerate(sessions):
            if i < sess.prompts.shape[1]:
                tok = sess.prompts[:, i:i + 1]
            else:
                tok = torch.argmax(sess.logits, dim=-1, keepdim=True)\
                    .to(torch.int32)
                sess.generated.append(tok)
            sess.logits, sess.cache = sess.step(tok)
            if (i + 1) % save_every == 0:
                tid = svc.save_session(f"s{s}", {"cache": sess.cache,
                                                 "cursor": {"pos": i + 1}})
                if log:
                    print(f"tok {i+1:3d} s{s}: snapshot TimeID={tid} "
                          f"(stall {svc.save_stalls[-1]*1e3:.1f} ms)",
                          flush=True)
    for ck in svc.pool:
        ck.wait()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0

    # TimeID order == submission order (the CAS counter is monotone), so
    # the merged trajectory reads like a single-session driver's.
    snap_stats = sorted((st for ck in svc.pool for st in ck.save_stats),
                        key=lambda st: st["time_id"])
    evict_stats = None
    if evict_last and n_sessions > 1:
        evict_stats = svc.evict_session(f"s{n_sessions - 1}")
        if log:
            print(f"evicted s{n_sessions-1}: "
                  f"{evict_stats.bytes_reclaimed/1e3:.1f} KB reclaimed in "
                  f"{svc.evict_latencies[-1]*1e3:.1f} ms")
    fleet = svc.fleet_stats()
    if log:
        print(f"served {n_sessions} sessions × {n_requests} requests × "
              f"{gen_tokens} tokens in {wall:.1f}s; "
              f"snapshots: {len(snap_stats)}, "
              f"dedup {fleet.dedup_ratio:.2f}x, "
              f"p99 stall {fleet.p99_save_stall_s*1e3:.1f} ms")
    gen = sessions[0].generated
    out = (torch.cat(gen, dim=1).cpu().numpy() if gen
           else np.zeros((n_requests, 0)))
    return {"tokens": out, "chipmink": svc.pool[0], "service": svc,
            "snap_stats": snap_stats, "fleet": fleet.as_dict(),
            "evict_stats": evict_stats, "wall": wall}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen1.5-0.5b")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--gen-tokens", type=int, default=32)
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--sessions", type=int, default=1,
                   help="concurrent sessions sharing the store")
    p.add_argument("--store", choices=("memory", "file"), default="memory",
                   help="store backend")
    p.add_argument("--store-dir", default=None,
                   help="file-store root (default: fresh temp dir)")
    p.add_argument("--async", dest="async_mode", action="store_true",
                   help="overlapped async saves")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model, caches and digests")
    a = p.parse_args()
    serve(a.arch, n_requests=a.requests, gen_tokens=a.gen_tokens,
          reduced=a.reduced, n_sessions=a.sessions, store=a.store,
          store_dir=a.store_dir, async_mode=a.async_mode, device=a.device)


if __name__ == "__main__":
    main()
