"""The training loop of a fine-tune that saves through Chipmink, driven
for a window: `repro_torch.launch.train.train`'s loop, with its defaults
(the traffic file's numbers), around the compiled train step.

Set-up makes the weights from the seed, builds one `TrainGraph` over one
training state, and drives it through ``setup_cycles`` save cycles: the
first ``reference_steps`` steps are the ones the reference follows, the
first save is the bootstrap (every byte), the next a warm incremental
one, and the pipeline is drained.  The window then runs steps of the
same graph, an async `save()` every ``save_every`` steps (bodies run
on through the window), reading each step's loss on the host as `train`
does, until ``--seconds`` have passed and a save has been made: whole
save cycles.

``correct`` compares:

- ``loss_gap``: each of the first steps' losses against the reference's,
  as a share of the reference's;
- ``grad_gap``: each trained leaf's first gradient as the optimizer got it
  (its first moment after one step over 1 - b1) against the reference's,
  by the worst leaf's gap of norms over the larger of that leaf's
  reference norm and the median leaf's;
- ``change_gap``: the same of each trained leaf's change over those
  steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone);
- ``window_loss_gap``, ``window_change_gap``: the same of the step that
  follows the first sampled commit of the window, which runs beside
  that commit's save body: the reference takes one step on its batch
  from the commit's state (the program's own: weights, moments and
  count, which the store check holds bit-exact to what was handed to
  `save`);
- ``store_mismatch``: leaves of commits made in the window (a sample
  drawn from the seed) that do not load back bit-exact;
- ``digest_mismatch``: sampled chunks of those commits whose committed
  digest is not the digest spec's of their bytes;
- ``frozen_written``: frozen leaves the window changed.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from chipbench.harness import checks, port
from chipbench.harness import traffic as gen
from chipbench.reference import counts
from chipbench.reference import model as ref


def on(batch: Dict, device) -> Dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def run(ctx) -> None:
    from repro_torch.core import LGA, Chipmink, MemoryStore
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (compile_train_step,
                                              init_train_state,
                                              make_train_step,
                                              touched_prefixes_from_metrics)
    t, cfg, dev, seed = ctx.cell.traffic, ctx.cell.config, ctx.device, \
        ctx.seed
    s = ref.Shape.of(cfg)
    arch = port.arch_config(cfg)
    o = t["optimizer"]
    opt = OptConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                    weight_decay=o["weight_decay"], clip_norm=o["clip_norm"])
    trained = gen.trained_prefixes(t["trained"], s.L)
    params = ref.make_params(s, seed, dev)
    frozen = tuple("params/" + g for g in
                   gen.frozen_prefixes(trained, list(params), s.L))
    keys = sorted(k for k in ref.flatten(params)
                  if any(k == p or k.startswith(p + "/") for p in trained))
    state = init_train_state(arch, params, opt)
    del params
    stream = gen.LMStream(t, s.V, seed)
    step_fn = make_train_step(arch, opt, frozen=frozen, remat=False)
    graph = compile_train_step(step_fn, state, on(stream(0), dev),
                               device=dev)
    store = MemoryStore()
    c = t["chipmink"]
    ck = Chipmink(store, LGA(), chunk_bytes=c["chunk_bytes"],
                  async_mode=c["async_mode"], device=dev)

    every, B, S = t["save_every"], t["batch"], t["seq_len"]
    n_ref = t["reference_steps"]
    spans, tracer = ctx.spans, ctx.tracer()
    timed = ctx.trace and cuda(dev)
    events: List = []
    losses: List[float] = []
    window_tids: List[int] = []
    sampled = set(gen.sample(seed, 1, t["check"]["commit_window"],
                             t["check"]["commits"]))
    expected: Dict[int, Dict] = {}
    prog: Dict[str, Dict] = {}
    wstep: Dict = {}                 # the window step the reference follows
    n_steps = 0

    def trained_leaves(tree: Dict) -> Dict[str, torch.Tensor]:
        flat = ref.flatten(tree)
        return {k: flat[k] for k in keys}

    def step(in_window: bool) -> bool:
        """One step, and the save it is due; True after a save."""
        nonlocal state, n_steps
        batch = on(stream(n_steps), dev)
        with spans.span("step"):
            if timed:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            state, metrics = graph(state, batch)
            if timed:
                ev[1].record()
                events.append(ev)
            losses.append(float(metrics["nll"]))
        n_steps += 1
        if n_steps == wstep.get("at", -2) + 1:
            wstep["loss"] = losses[-1]
            wstep["after"] = {k: v.clone() for k, v in
                              trained_leaves(state["params"]).items()}
        if n_steps % every:
            return False
        touched = touched_prefixes_from_metrics(arch, metrics, frozen)
        snap = {"params": state["params"], "opt": state["opt"],
                "step": int(state["step"]),
                "data": {"seed": seed, "step": n_steps, "host_index": 0,
                         "host_count": 1}}
        with spans.span("save"):
            tid = ck.save(snap, touched_prefixes=touched)
        if in_window:
            if len(window_tids) in sampled:
                # what this commit holds beyond the frozen leaves, which
                # the window never changes
                expected[tid] = {"step": snap["step"], **{
                    f"data/{k}": v for k, v in snap["data"].items()}}
                for part, tree in (("params/", state["params"]),
                                   ("opt/mu/", state["opt"]["mu"]),
                                   ("opt/nu/", state["opt"]["nu"])):
                    expected[tid].update({part + k: v.clone() for k, v in
                                          trained_leaves(tree).items()})
                if not wstep:
                    wstep.update(at=n_steps, tid=tid)
            window_tids.append(tid)
        return True

    # -- set-up ------------------------------------------------------------
    for _ in range(t["setup_cycles"] * every):
        step(False)
        if n_steps == 1:
            prog["mu1"] = {k: v.clone() for k, v in
                           trained_leaves(state["opt"]["mu"]).items()}
        if n_steps == n_ref:
            prog["params"] = {k: v.clone() for k, v in
                              trained_leaves(state["params"]).items()}
    prog["losses"] = losses[:n_ref]
    ck.wait()
    if cuda(dev):
        torch.cuda.synchronize(dev)
    base = store.total_bytes()

    # -- the window --------------------------------------------------------
    t0 = ctx.window_open()
    first = n_steps
    # whole save cycles: until --seconds have passed and a save was made
    while True:
        saved = step(True)
        if tracer:
            tracer.tick()
        if saved and time.perf_counter() - t0 >= ctx.seconds:
            break
    t1 = ctx.window_close()
    n = n_steps - first
    if tracer:
        tracer.close()
    ck.wait()
    if cuda(dev):
        torch.cuda.synchronize(dev)
    rec = ctx.record
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if cuda(dev) else 0)
    rec["e2e"] = {"train_tokens_per_s": n * B * S / (t1 - t0)}
    rec["attempted"] = n
    rec["failed"] = sum(not math.isfinite(x) for x in losses[first:])
    in_window = set(window_tids)
    leaves = [(v.numel() * v.element_size(), v.element_size())
              for v in checks.flat_leaves(
                  {"params": state["params"], "opt": state["opt"]}).values()]
    rec.update(
        save_stats=[st for st in ck.save_stats if st["time_id"] in in_window],
        save_calls_s=spans.durations("save", t0, t1),
        step_ms=[a.elapsed_time(b) for a, b in events],
        n_saves=len(window_tids),
        store_growth_bytes=store.total_bytes() - base,
        flops_per_step=counts.train_step_flops(
            s, B, S, [int(p.split("/")[1]) for p in trained
                      if p.startswith("layers/")],
            "embed" in trained, "final_norm" in trained),
        digest_bound_s=counts.digest_bound_s(
            *counts.digest_work(leaves, c["chunk_bytes"])),
        trace=tracer.reduce() if tracer else None)

    # -- correct: the store ------------------------------------------------
    chk = checks.Checks(ctx.cell.limits)
    start = ref.flatten(ref.make_params(s, seed, dev))
    live = checks.flat_leaves({"params": state["params"],
                               "opt": state["opt"]})
    written = 0
    for k, v in start.items():
        if k in keys:
            continue
        written += not checks.same(live["params/" + k], v)
        for m in ("mu", "nu"):
            written += bool(torch.any(live[f"opt/{m}/{k}"] != 0))
    chk.add("frozen_written", written)
    store_bad = digest_bad = checked = 0
    for tid, exp in sorted(expected.items()):
        want = {**live, **exp}
        store_bad += checks.tree_mismatches(ck.load(time_id=tid), want)
        tensors = {k: v for k, v in want.items()
                   if isinstance(v, torch.Tensor)}
        c_n, c_bad = checks.digest_mismatches(
            store.get_manifest(tid), tensors, c["chunk_bytes"],
            chunk_pick(seed, tid, tensors, keys, c["chunk_bytes"],
                       t["check"]["chunks_per_commit"]))
        checked += c_n
        digest_bad += c_bad
    chk.add("store_mismatch", store_bad if expected else 1)
    chk.add("digest_mismatch", digest_bad if checked else 1)

    # -- correct: the model, once the program's state is freed ---------------
    at = expected.get(wstep.get("tid"), {})
    del graph, state, ck, store, expected, live
    if cuda(dev):
        torch.cuda.empty_cache()
    adamw = ref.AdamW(**o)
    r = ref.train_steps(ref.unflatten(start),
                        [on(stream(k), dev) for k in range(n_ref)], s,
                        trained, adamw)
    readings(chk, prog["losses"],
             {k: v.float() / (1 - opt.b1) for k, v in prog["mu1"].items()},
             {k: v.float() - start[k].float()
              for k, v in prog["params"].items()}, r)
    if "after" in wstep:
        # the commit's state: the frozen leaves as made, the trained ones
        # and the moments as committed
        w = {"params": ref.unflatten({**start, **{
                 k: at["params/" + k] for k in keys}}),
             "moments": tuple({k: at[f"opt/{m}/" + k] for k in keys}
                              for m in ("mu", "nu")),
             "count0": wstep["at"], "batch": on(stream(wstep["at"]), dev)}
        w["ref"] = ref.train_steps(w["params"], [w["batch"]], s, trained,
                                   adamw, moments=w["moments"],
                                   count0=w["count0"])
        window_readings(chk, wstep["loss"],
                        {k: v.float() - at["params/" + k].float()
                         for k, v in wstep["after"].items()}, w["ref"])
        rec["window_step"] = w
    else:
        chk.add("window_loss_gap", float("inf"))
        chk.add("window_change_gap", float("inf"))
    rec["checks"] = chk


def readings(chk, losses, grad: Dict, change: Dict, r: Dict) -> None:
    """First steps against the reference's: losses, first gradients
    (as the optimizer got them), changes."""
    chk.add("loss_gap", max(abs(p - q) / abs(q) for p, q in
                            zip(losses, r["losses"])))
    chk.add("grad_gap", checks.norm_gap(grad, r["grad"]))
    chk.add("change_gap", checks.norm_gap(change, r["change"],
                                          checks.moved(r["grad"])))


def window_readings(chk, loss: float, change: Dict, r: Dict) -> None:
    """The window step against the reference's one step from the same
    commit: its loss, and each trained leaf's change."""
    q = r["losses"][0]
    chk.add("window_loss_gap", abs(loss - q) / abs(q))
    chk.add("window_change_gap", checks.norm_gap(change, r["change"],
                                                 checks.moved(r["grad"])))


def chunk_pick(seed: int, tid: int, tensors: Dict[str, torch.Tensor],
               trained: List[str], chunk_bytes: int, n: int):
    """Which chunks of a commit to check: n drawn from the seed, half
    from every chunk of the state, half from the trained leaves'."""
    from chipbench.reference.digest import n_chunks_of
    grid = [(k, n_chunks_of(v.numel() * v.element_size(), v.element_size(),
                            chunk_bytes)) for k, v in sorted(tensors.items())]
    hot = [(k, c) for k, c in grid
           if any(k.endswith("/" + t) for t in trained)]
    picks: Dict[str, set] = {}
    for tag, pool in ((tid * 2, grid), (tid * 2 + 1, hot)):
        total = sum(c for _, c in pool)
        for i in gen.sample(seed, 100 + tag, total, n // 2):
            for k, c in pool:
                if i < c:
                    picks.setdefault(k, set()).add(i)
                    break
                i -= c
    return lambda key, n_chunks: picks.get(key, ())
