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
from ..models.model import api
from .grad_compress import tree_quantize_dequantize
from .optimizer import (OptConfig, clip_by_global_norm, is_frozen, opt_init,
                        opt_update)
from .tree import tree_leaves, tree_map, tree_replace


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
