"""The serving loop of sessions that snapshot through a `SessionService`,
driven for a window: `repro_torch.launch.serve.serve`'s round-robin loop
and its service settings (the traffic file's numbers), one compiled
decode step (`DecodeGraph`) per session.

Each session serves turns of ``requests`` requests in lockstep: the
prompt is fed token by token through the decode graph, as `serve` feeds
it, then ``gen_tokens`` tokens are generated greedily.  Each generated
token is read on the host as soon as its step has run (a server streams
it to its user); its gap is the host time since the same request's
previous token.  When a turn ends, the session's next turn starts in the
same cache tensors at position 0 with a new prompt from the seed.  Every
``save_every`` decode steps of a session its cache is snapshotted by
`save_session` (a sync save: its stall holds the loop).

The window runs whole rounds (each session one step) until ``--seconds``
have passed and every session has snapshotted since.

Set-up makes the weights from the seed, opens the sessions, compiles
their graphs and advances session s by ``first_offset_steps + s *
stagger_steps`` steps, snapshots included, so turns start at different
times of the window.

``correct`` compares:

- ``token_gap``: for a sample, drawn from the seed, of the requests of
  turns that started inside the window (each served to its end, past
  the window's close where it runs on, by the same loop with its
  snapshots), the widest gap by which a served token's logit lies below
  the best logit of the float32 reference's full forward pass over the
  request's prompt and served tokens;
- ``logit_err``: for the same requests, the median distance, over
  their served positions, between the logits the program chose each
  token from and the reference's, as a share of the reference's;
- ``slot_err``: the same median over each batch slot's requests (the
  sample holds as many of each slot), for the worst slot;
- ``store_mismatch``: leaves of snapshots taken in the window (a sample
  drawn from the seed) that do not load back bit-exact;
- ``digest_mismatch``: chunks of those snapshots whose committed digest
  is not the digest spec's of their bytes (every chunk).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from chipbench.harness import checks, port
from chipbench.harness import traffic as gen
from chipbench.reference import counts
from chipbench.reference import model as ref


class Session:
    def __init__(self, sid: int, graph, gen_tokens: int) -> None:
        self.sid, self.graph, self.gen_tokens = sid, graph, gen_tokens
        self.turn, self.i, self.n = 0, 0, 0
        self.next_tok = None
        self.last_token_at = None

    def start(self, prompt: np.ndarray, device, keep: bool) -> None:
        """A new turn at position 0: its prompt, a row per request for
        the prompt and the tokens it is served, and (with `keep`, for a
        turn the check judges) a copy of the logits each served token is
        chosen from."""
        self.i = 0
        self.kept = [] if keep else None
        self.prompt = torch.from_numpy(prompt).to(device)
        self.seq = np.concatenate(
            [prompt, np.zeros((prompt.shape[0], self.gen_tokens),
                              np.int32)], axis=1)
        self.last_token_at = None


def cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def run(ctx) -> None:
    from repro_torch.core import LGA, MemoryStore
    from repro_torch.models.model import api
    from repro_torch.sessions import SessionService
    from repro_torch.train.serve_step import compile_decode_step
    t, cfg, dev, seed = ctx.cell.traffic, ctx.cell.config, ctx.device, \
        ctx.seed
    s = ref.Shape.of(cfg)
    arch = port.arch_config(cfg)
    R, P, G = t["requests"], t["prompt_tokens"], t["gen_tokens"]
    every, T = t["save_every"], t["cache_slots"]
    if P + G - 1 > T:
        raise ValueError("a turn must fit the cache slots")
    c = t["chipmink"]
    store = MemoryStore()
    svc = SessionService(store, pool_size=c["pool_size"], policy=LGA(),
                         chunk_bytes=c["chunk_bytes"],
                         async_mode=c["async_mode"], device=dev)
    params = ref.make_params(s, seed, dev)
    convo = gen.Conversations(t, s.V, seed)
    m = api(arch)
    sessions: List[Session] = []
    for sid in range(t["sessions"]):
        svc.open_session(f"s{sid}")
        cache = m.init_cache(arch, R, T, device=dev)
        graph = compile_decode_step(arch, params, cache, device=dev)
        x = Session(sid, graph, G)
        x.start(convo(sid, 0), dev, keep=False)
        sessions.append(x)

    spans, tracer = ctx.spans, ctx.tracer()
    timed = ctx.trace and cuda(dev)
    events: List = []
    positions: List[int] = []
    gaps_ms: List[float] = []
    finished: List[tuple] = []
    window_tids: List[int] = []
    sampled = set(gen.sample(seed, 2, t["check"]["commit_window"],
                             t["check"]["commits"]))
    expected: Dict[int, Dict] = {}
    served = 0
    window = [float("inf")]          # the window's opening time, once open

    def step(x: Session) -> None:
        nonlocal served
        tok = x.prompt[:, x.i:x.i + 1] if x.i < P else x.next_tok
        with spans.span("decode"):
            if timed:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            logits, cache = x.graph(tok)
            if timed:
                ev[1].record()
            if x.i >= P - 1:
                if x.kept is not None:
                    x.kept.append(logits.clone())
                nxt = torch.argmax(logits, dim=-1, keepdim=True) \
                    .to(torch.int32)
                host = nxt.cpu().numpy()[:, 0]
        if timed and window[0] <= time.perf_counter():
            events.append(ev)
            positions.append(x.i)
        x.i += 1
        x.n += 1
        if x.i >= P:
            now = time.perf_counter()
            k = x.i - P
            x.seq[:, P + k] = host
            if now >= window[0]:
                served += R
                if k and x.last_token_at >= window[0]:
                    gaps_ms.extend([(now - x.last_token_at) * 1e3] * R)
            x.last_token_at = now
            x.next_tok = nxt
        if x.n % every == 0:
            state = {"cache": cache, "cursor": {"pos": x.i}}
            with spans.span("save_session"):
                tid = svc.save_session(f"s{x.sid}", state)
            if time.perf_counter() >= window[0]:
                if len(window_tids) in sampled:
                    expected[tid] = {"cursor/pos": x.i, **{
                        k: v.clone() for k, v in
                        checks.flat_leaves({"cache": cache}).items()}}
                window_tids.append(tid)
        if x.i == P + G - 1:
            finished.append((x.seq, None if x.kept is None
                             else torch.stack(x.kept, dim=1)))
            x.turn += 1
            x.graph.cache["pos"].zero_()
            x.start(convo(x.sid, x.turn), dev,
                    keep=time.perf_counter() >= window[0])

    # -- set-up ------------------------------------------------------------
    for x in sessions:
        for _ in range(t["first_offset_steps"] + x.sid * t["stagger_steps"]):
            step(x)
    for ck in svc.pool:
        ck.wait()
    if cuda(dev):
        torch.cuda.synchronize(dev)
    base = store.total_bytes()

    # -- the window --------------------------------------------------------
    t0 = ctx.window_open()
    window[0] = t0
    stalls0 = len(svc.save_stalls)
    # whole rounds, until --seconds have passed and every session has
    # snapshotted since: tokens come in bursts between snapshot rounds,
    # and a window cut inside a round would count a part of one
    late: set = set()
    while len(late) < len(sessions):
        over = time.perf_counter() - t0 >= ctx.seconds
        for x in sessions:
            step(x)
            if tracer:
                tracer.tick()
            if over and x.n % every == 0:
                late.add(x.sid)
    t1 = ctx.window_close()
    window[0] = float("inf")
    if tracer:
        tracer.close()
    for ck in svc.pool:
        ck.wait()
    if cuda(dev):
        torch.cuda.synchronize(dev)
    rec = ctx.record
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if cuda(dev) else 0)
    from chipbench.harness.stats import percentile
    rec["e2e"] = {"serve_tokens_per_s": served / (t1 - t0),
                  "token_gap_p95_ms": percentile(gaps_ms, 95.0)}
    rec["attempted"] = served
    rec["failed"] = 0
    in_window = set(window_tids)
    cache_leaves = [(v.numel() * v.element_size(), v.element_size())
                    for v in checks.flat_leaves(
                        sessions[0].graph.cache).values()]
    rec.update(
        save_stats=sorted((st for ck in svc.pool for st in ck.save_stats
                           if st["time_id"] in in_window),
                          key=lambda st: st["time_id"]),
        save_stalls_s=svc.save_stalls[stalls0:],
        decode_ms=[a.elapsed_time(b) for a, b in events],
        decode_flops=sum(counts.decode_step_flops(s, R, [p] * R)
                         for p in positions),
        n_saves=len(window_tids),
        store_growth_bytes=store.total_bytes() - base,
        digest_bound_s=counts.digest_bound_s(
            *counts.digest_work(cache_leaves, c["chunk_bytes"])),
        trace=tracer.reduce() if tracer else None)

    # -- the turns that started inside the window, served to their end --
    while True:
        due = [x for x in sessions if x.kept is not None]
        if not due:
            break
        for x in due:
            step(x)
    for ck in svc.pool:
        ck.wait()

    # -- correct: the store ------------------------------------------------
    chk = checks.Checks(ctx.cell.limits)
    store_bad = digest_bad = checked = 0
    for tid, want in sorted(expected.items()):
        store_bad += checks.tree_mismatches(svc.pool[0].load(time_id=tid),
                                            want)
        tensors = {k: v for k, v in want.items()
                   if isinstance(v, torch.Tensor)}
        c_n, c_bad = checks.digest_mismatches(
            store.get_manifest(tid), tensors, c["chunk_bytes"],
            lambda key, n: range(n))
        checked += c_n
        digest_bad += c_bad
    chk.add("store_mismatch", store_bad if expected else 1)
    chk.add("digest_mismatch", digest_bad if checked else 1)

    # -- correct: the served tokens, once the program's state is freed ------
    turns = [f for f in finished if f[1] is not None]
    pick = [(i, r) for r in range(R) for i in gen.sample(
        seed, 3 + r, len(turns), t["check"]["requests"] // R)]
    seqs = torch.from_numpy(np.stack([turns[i][0][r] for i, r in pick])) \
        .to(dev) if pick else None
    logits = torch.stack([turns[i][1][r] for i, r in pick]) if pick else None
    slots = [r for _, r in pick]
    svc.close()
    del svc, sessions, store, expected, params, finished, turns
    if cuda(dev):
        torch.cuda.empty_cache()
    if seqs is None:
        for name in ("token_gap", "logit_err", "slot_err"):
            chk.add(name, float("inf"))
    else:
        scores = ref.served_scores(ref.make_params(s, seed, dev), s, seqs,
                                   P, logits=logits, slots=slots)
        for name, v in zip(("token_gap", "logit_err", "slot_err"), scores):
            chk.add(name, v)
        rec["served"] = {"seqs": seqs, "logits": logits, "slots": slots,
                         "prompt": P}
    rec["checks"] = chk
