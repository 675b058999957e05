"""Optimizers: AdamW and factored Adafactor, as pure functions over
nested dicts of tensors.  The port of `repro.train.optimizer`.

TrainState = {"params": tree, "opt": tree, "step": 0-d int32 tensor}.
Every update returns new tensors and changes no state in place.  Frozen
parameters (fine-tuning) are a `frozen` path-prefix list in the train-step
factory: their updates are zeroed *and* their paths feed Chipmink's
active-variable filter.  Each step follows the reference's float32
arithmetic op by op; the step counter stays on the device.

`opt_axes` (the optimizer state's logical sharding axes) waits for the
mesh (ROADMAP.md section 1, item 4).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch

from .tree import tree_leaves, tree_map, tree_replace, tree_unzip


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"       # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    eps_factored: float = 1e-30
    clip_norm: float = 1.0


def is_frozen(path: Tuple[str, ...], frozen: Sequence[str]) -> bool:
    p = "/".join(path)
    return any(p == f or p.startswith(f + "/") for f in frozen)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


# -- AdamW -------------------------------------------------------------------

def adamw_init(params: Any) -> Dict:
    return {"mu": tree_map(_zeros_f32, params),
            "nu": tree_map(_zeros_f32, params)}


def adamw_update(grads, opt, params, step: torch.Tensor, cfg: OptConfig):
    """One AdamW step over every leaf at once: `torch._foreach_*` ops (a
    few multi-tensor launches on the card instead of ~20 per leaf) that
    round each element exactly where the reference's per-leaf expressions
    do; only the casts go leaf by leaf."""
    count = step.float() + 1.0
    bc1 = 1.0 - cfg.b1 ** count
    bc2 = 1.0 - cfg.b2 ** count
    mul, add, div = torch._foreach_mul, torch._foreach_add, torch._foreach_div
    ps = tree_leaves(params)
    g = [x.float() for x in tree_leaves(grads)]
    p = [x.float() for x in ps]
    m = add(mul(tree_leaves(opt["mu"]), cfg.b1), mul(g, 1 - cfg.b1))
    v = add(mul(tree_leaves(opt["nu"]), cfg.b2), mul(mul(g, 1 - cfg.b2), g))
    u = div(div(m, bc1), add(torch._foreach_sqrt(div(v, bc2)), cfg.eps))
    u = add(u, mul(p, cfg.weight_decay))
    new = torch._foreach_sub(p, mul(u, cfg.lr))
    new_p = [n.to(x.dtype) for n, x in zip(new, ps)]
    return tree_replace(params, new_p), {"mu": tree_replace(params, m),
                                         "nu": tree_replace(params, v)}


# -- Adafactor ---------------------------------------------------------------

def _factored(shape: Tuple[int, ...]) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params: Any) -> Dict:
    def slot(p):
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return {"v": _zeros_f32(p)}

    return {"v": tree_map(slot, params)}


def adafactor_update(grads, opt, params, step: torch.Tensor, cfg: OptConfig):
    count = step.float() + 1.0
    decay = 1.0 - count ** -0.8

    def upd(p, g, s):
        g = g.float()
        g2 = g * g + cfg.eps_factored
        if _factored(p.shape):
            vr = decay * s["vr"] + (1 - decay) * torch.mean(g2, dim=-1)
            vc = decay * s["vc"] + (1 - decay) * torch.mean(g2, dim=-2)
            rf = vr / torch.mean(vr, dim=-1, keepdim=True)
            u = g / (torch.sqrt(rf)[..., None] * torch.sqrt(vc)[..., None, :]
                     + cfg.eps)
            new_s = {"vr": vr, "vc": vc}
        else:
            v = decay * s["v"] + (1 - decay) * g2
            u = g / (torch.sqrt(v) + cfg.eps)
            new_s = {"v": v}
        # update clipping (RMS <= 1) as in the paper's Adafactor
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        u = u + cfg.weight_decay * p.float()
        return (p.float() - cfg.lr * u).to(p.dtype), new_s

    new_p, new_s = tree_unzip(tree_map(upd, params, grads, opt["v"]), 2)
    return new_p, {"v": new_s}


# -- shared -----------------------------------------------------------------

def opt_init(params: Any, cfg: OptConfig) -> Dict:
    return adamw_init(params) if cfg.name == "adamw" else adafactor_init(params)


def opt_update(grads, opt, params, step: torch.Tensor, cfg: OptConfig):
    if cfg.name == "adamw":
        return adamw_update(grads, opt, params, step, cfg)
    return adafactor_update(grads, opt, params, step, cfg)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares, leaf by leaf in the reference's
    flatten order (dict keys sorted), in float32."""
    x = [t.float() for t in tree_leaves(tree)]
    return torch.sqrt(sum(torch.sum(sq) for sq in torch._foreach_mul(x, x)))


def clip_by_global_norm(grads: Any, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    leaves = tree_leaves(grads)
    scaled = torch._foreach_mul([g.float() for g in leaves], scale)
    return tree_replace(grads, [s.to(g.dtype) for s, g in
                                zip(scaled, leaves)]), norm
