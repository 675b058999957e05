"""Train-step factory: loss + grad + optimizer update as one function over
TrainState = {"params", "opt", "step" [, "ef"]}.  The port of
`repro.train.train_step`.

  * microbatch gradient accumulation (a Python loop; the reference's
    unrolled and `lax.scan` forms compute the same sums in the same
    order, so ``microbatch_scan`` selects nothing here),
  * activation checkpointing (remat) per layer,
  * frozen-parameter masks (updates zeroed; the frozen leaves come back
    as the very tensor objects they were, which the static checker
    `core.ascc` proves and Chipmink's active-variable filter then skips),
  * optional int8 error-feedback gradient compression,
  * the MoE touch report's `touched_prefixes_from_metrics`.

`compile_train_step` is the port's counterpart of the reference's
`jax.jit(make_train_step(...))` (`repro.launch.train`): a `TrainGraph`
binds one TrainState and, on a card, replays the whole step (forward,
backward and optimizer) as one CUDA graph per call, writing the new
state into the state's own tensors.

Gradients come from `value_and_grad`, the counterpart of
`jax.value_and_grad(..., has_aux=True)` built on `torch.autograd.grad`:
`torch.func.grad_and_value` refuses the saved-tensor hooks that
non-reentrant `torch.utils.checkpoint` (remat) installs.  A step reads no
tensor value on the host, so it runs with no device sync and runs on meta
tensors for the static checker.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.trace import span
from ..models.model import api
from .grad_compress import tree_quantize_dequantize
from .optimizer import (OptConfig, clip_by_global_norm, is_frozen, opt_init,
                        opt_update)
from .serve_step import WARMUP_STEPS, graph_device
from .tree import tree_leaves, tree_leaves_with_paths, tree_map, tree_replace


def init_train_state(cfg: ArchConfig, params: Any, opt_cfg: OptConfig,
                     grad_compress: bool = False) -> Dict:
    device = tree_leaves(params)[0].device
    state = {"params": params, "opt": opt_init(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if grad_compress:
        state["ef"] = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.bfloat16, device=p.device), params)
    return state


def value_and_grad(fn: Callable) -> Callable:
    """``fn(params, *args) -> (loss, aux)`` to ``(params, *args) ->
    ((loss, aux), grads)``: grads of the scalar loss with respect to every
    leaf of the nested dict ``params``, in the leaves' dtypes (zeros for a
    leaf the loss does not use).  Loss, aux and grads come back detached;
    the caller's tensors are never marked as requiring grad."""
    def run(params: Any, *args: Any):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            loss, aux = fn(live, *args)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        aux = tree_map(lambda a: a.detach() if isinstance(a, torch.Tensor)
                       else a, aux)
        return (loss.detach(), aux), tree_replace(live, list(grads))

    return run


def _zero_frozen(grads: Any, frozen: Sequence[str], prefix=()) -> Any:
    if not frozen:
        return grads
    if isinstance(grads, dict):
        return {k: _zero_frozen(v, frozen, prefix + (k,))
                for k, v in grads.items()}
    return torch.zeros_like(grads) if is_frozen(prefix, frozen) else grads


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig, *,
                    microbatches: int = 1,
                    frozen: Sequence[str] = (),
                    grad_compress: bool = False,
                    q_chunk: Optional[int] = None,
                    remat: Optional[bool] = None,
                    microbatch_scan: bool = False,
                    accum_dtype: torch.dtype = torch.float32) -> Callable:
    """The reference's factory and options.  ``microbatch_scan`` is kept
    for its signature: the reference's scan and its unrolled loop add the
    same terms in the same order, and so does the one loop here.
    ``accum_dtype=torch.bfloat16`` halves the gradient accumulator."""
    del microbatch_scan
    m = api(cfg)
    remat = cfg.remat if remat is None else remat
    # frozen specs may be given as state paths ("params/layers/0") or
    # params-subtree paths ("layers/0"); normalize to the latter since the
    # masks walk the params tree
    frozen = tuple(f[len("params/"):] if f.startswith("params/") else f
                   for f in frozen)

    def loss_fn(params, mb):
        return m.loss_fn(params, mb, cfg, q_chunk=q_chunk, remat=remat)

    grad_fn = value_and_grad(loss_fn)

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        if microbatches == 1:
            (loss, metrics), grads = grad_fn(params, batch)
        else:
            loss = 0.0
            metrics: Dict = {}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=accum_dtype, device=p.device), params)
            for i in range(microbatches):
                mb = {k: x[i * (x.shape[0] // microbatches):
                           (i + 1) * (x.shape[0] // microbatches)]
                      for k, x in batch.items()}
                (l, met), g = grad_fn(params, mb)
                loss = loss + l / microbatches
                grads = tree_map(
                    lambda a, b: a + (b / microbatches).to(a.dtype), grads, g)
                metrics = met  # keep last microbatch's aux
            metrics["nll"] = loss

        grads = _zero_frozen(grads, frozen)
        new_ef = None
        if grad_compress:
            grads, new_ef = tree_quantize_dequantize(grads, state.get("ef"))
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm)
        new_params, new_opt = opt_update(grads, state["opt"], params,
                                         state["step"], opt_cfg)
        # frozen leaves pass through as the SAME tensor objects (the static
        # checker proves them read-only; Chipmink skips their pods without
        # hashing)
        if frozen:
            def keep_frozen(new, old, prefix=()):
                if isinstance(new, dict):
                    return {k: keep_frozen(new[k], old[k], prefix + (k,))
                            for k in new}
                return old if is_frozen(prefix, frozen) else new
            new_params = keep_frozen(new_params, params)

        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        if grad_compress:
            new_state["ef"] = new_ef
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return new_state, metrics

    return train_step


class TrainGraph:
    """One TrainState's train step; built by `compile_train_step`.
    ``step(state, batch)`` -> ``(state, metrics)``.

    Its static buffers are one tensor per batch key (the example batch's
    shapes and dtypes), the state's own tensors, and one tensor per
    metric.  `state` comes back as the same dict of the same tensors at
    every call, written in place; `metrics` is one dict of buffers that
    the next call overwrites.  The body is ``step_fn(state, batch)``
    unchanged, then an in-place copy of each new leaf into the state's
    own tensor.  A leaf the step hands back as the very tensor it got (a
    frozen parameter, which `core.ascc` proves read-only) is never
    written, so Chipmink's read-only skip stays sound.  The step counter
    stays a 0-d int32 tensor on the device.

    On a card, `WARMUP_STEPS` eager calls on a side stream come first
    (the eager step writes none of its inputs, so they run on the state
    itself and their results are dropped); then the body is captured
    once, and each call copies the batch in and replays the graph on the
    current stream.  An async save's snapshot, taken on that stream, thus
    stays ordered before the next step's in-place writes.  The graph's
    private memory pool keeps every temporary of the step (activations,
    gradients, the optimizer's float32 casts and moments before the copy
    back); nothing a caller keeps lives in it.  On the CPU each call runs
    the same body eagerly through the same buffers.

    A graph is bound to the tensors it captured: when a restore or a
    checkout hands back new tensors, compile a new step over them.
    """

    def __init__(self, step_fn: Callable, state: Dict, batch: Dict,
                 device: torch.device) -> None:
        self._step_fn = step_fn
        self.state = state
        self._paths = tree_leaves_with_paths(state)
        self.batch = {k: v.clone() for k, v in batch.items()}
        self.metrics: Optional[Dict] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        if device.type == "cuda":
            self._capture(device)

    def _body(self) -> None:
        new, metrics = self._step_fn(self.state, self.batch)
        got = tree_leaves_with_paths(new)
        if [p for p, _ in got] != [p for p, _ in self._paths]:
            raise ValueError("compile_train_step: the step's new state has "
                             "other leaves than the state it was given")
        for (path, old), (_, leaf) in zip(self._paths, got):
            if leaf is old:
                continue
            if leaf.shape != old.shape or leaf.dtype != old.dtype:
                raise ValueError(f"compile_train_step: new {path} is "
                                 f"{leaf.dtype}{list(leaf.shape)}, the "
                                 f"state's {old.dtype}{list(old.shape)}")
            old.copy_(leaf)
        if self.metrics is None:
            self.metrics = {k: torch.empty_like(v) for k, v in metrics.items()}
        for k, v in metrics.items():
            self.metrics[k].copy_(v)

    def _capture(self, device: torch.device) -> None:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                # one new state alive at a time
                metrics = self._step_fn(self.state, self.batch)[1]
            self.metrics = {k: torch.empty_like(v) for k, v in metrics.items()}
        torch.cuda.current_stream(device).wait_stream(side)
        del metrics
        graph = torch.cuda.CUDAGraph()
        # thread-local: an async save body on another thread may sync or
        # allocate while this thread captures.  A sync in the body itself
        # still fails the capture, which raises.
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            self._body()
        self.graph = graph

    def __call__(self, state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        with span("train.step"):
            leaves = tree_leaves(state)
            if len(leaves) != len(self._paths) or any(
                    a is not b for a, (_, b) in zip(leaves, self._paths)):
                raise ValueError("compile_train_step: a state other than "
                                 "the one the step was compiled over; "
                                 "compile a new step over it")
            if sorted(batch) != sorted(self.batch):
                raise ValueError(f"compile_train_step: batch keys "
                                 f"{sorted(batch)}, compiled for "
                                 f"{sorted(self.batch)}")
            for k, v in batch.items():
                buf = self.batch[k]
                if (v.shape, v.dtype, v.device) != (buf.shape, buf.dtype,
                                                    buf.device):
                    raise ValueError(f"compile_train_step: batch {k!r} is "
                                     f"{v.dtype}{list(v.shape)} on "
                                     f"{v.device}, compiled for {buf.dtype}"
                                     f"{list(buf.shape)} on {buf.device}")
                buf.copy_(v)
            if self.graph is None:
                self._body()
            else:
                self.graph.replay()
            return self.state, self.metrics


def compile_train_step(step_fn: Callable, state: Dict, example_batch: Dict,
                       *, device: Any = "cuda") -> TrainGraph:
    """The port's `jax.jit(make_train_step(...))` for one TrainState: a
    `TrainGraph` over `state` (see there).  `step_fn` is the eager step
    `make_train_step` returns, the one the static checker traces.  Every
    leaf of `state` and `example_batch` must lie on `device`, ``"cuda"``
    by default: there the step is captured as a CUDA graph, and a failed
    capture or replay raises.  ``device="cpu"`` runs the same body
    eagerly.  DTensors (a mesh's steps, the dry-run's meta shards) never
    go through a graph: they raise, and `make_train_step` runs them."""
    device = graph_device("compile_train_step", "make_train_step", device,
                          tree_leaves((state, example_batch)))
    return TrainGraph(step_fn, state, example_batch, device)


def touched_prefixes_from_metrics(cfg: ArchConfig, metrics: Dict,
                                  frozen: Sequence[str] = ()) -> Optional[List[str]]:
    """Derive Chipmink `touched_prefixes` from the step's touch report.

    For MoE models, `expert_counts` (n_moe_layers, X) marks experts that
    received tokens this window; untouched experts' parameter/optimizer
    pods are provably clean.  Returns None (= everything may be touched)
    when no report is available.
    """
    if "expert_counts" not in metrics or cfg.moe is None:
        return None
    counts = metrics["expert_counts"]
    if isinstance(counts, torch.Tensor):
        counts = counts.cpu()
    counts = np.asarray(counts)  # (n_moe_layers, X)
    plan = cfg.layer_plan()
    moe_layers = [i for i, (_mx, f) in enumerate(plan) if f == "moe"]
    touched: List[str] = []
    # non-expert state is always (potentially) touched
    touched.append("params/embed")
    if not cfg.tie_embeddings:
        touched.append("params/lm_head")
    touched.append("params/final_norm")
    if cfg.vlm is not None:
        touched.append("params/patch_proj")
    for li, layer in enumerate(moe_layers):
        base = f"params/layers/{layer}"
        for name in ("norm1", "norm2"):
            touched.append(f"{base}/{name}")
        touched.append(f"{base}/attn")
        for shared in ("shared_gate", "shared_up", "shared_down", "router"):
            touched.append(f"{base}/ffn/{shared}")
        # expert tensors are row-sliced per expert; the AVF works at leaf
        # granularity, so any active expert marks the leaf as active —
        # chunk-level change detection then isolates the dirty expert rows
        if counts[li].max() > 0:
            touched.append(f"{base}/ffn")
    for i, (_mx, f) in enumerate(plan):
        if f != "moe":
            touched.append(f"params/layers/{i}")
    # optimizer/step mirror params
    touched.extend(["opt", "step", "ef", "data"])
    return [t for t in touched
            if not any(t == f or t.startswith(f + "/") for f in frozen)]
