"""Mixture-of-Experts FFN: top-k routing with capacity-factor dispatch
(GShard-style dense one-hot einsums) + optional shared expert.  The port
of `repro.models.moe`.

Dispatch and combine are the reference's dense one-hot tensors (G, n, X,
C): a token's j-th choice takes the next free slot of its expert in its
group, and a choice past the capacity C is dropped.  Every shape is
known on the host, so a step makes no device sync; a sort-and-gather
grouping would need the group sizes on the host and would drop other
tokens.

Two points where torch and JAX differ are made explicit:

  * ties: `jax.lax.top_k` puts the lower index first among equal values;
    `torch.topk` promises no order.  `top_k` here is a stable descending
    sort, which keeps the lower index first;
  * integer sums: `jnp.cumsum`/`jnp.sum` of int32 stay int32, torch's
    become int64; the sums here name int32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..parallel.sharding import constrain, einsum, reshape
from .layers import dense, silu, swiglu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_ff: int
    n_shared: int = 0          # shared experts (always-on), DeepSeek/K2 style
    capacity_factor: float = 1.25
    n_groups: int = 16         # token groups (≈ data-parallel shards)
    ep_logical: str = "experts"  # logical axis of the expert dim


def _capacity(n_tokens_per_group: int, cfg: MoEConfig) -> int:
    c = int(n_tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to 8


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last dim and their indices, in
    descending order, equal values by ascending index
    (`jax.lax.top_k`'s rule)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """`jax.nn.one_hot`: an index outside [0, n) gives a zero row (no
    range check, so no host sync)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def router_dispatch(logits: torch.Tensor, cfg: MoEConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits: (G, n, X) -> dispatch (G, n, X, C) bf16 one-hot, combine
    (G, n, X, C) bf16 weights, aux load-balancing loss (0-d float32)."""
    G, n, X = logits.shape
    C = _capacity(n, cfg)
    probs = torch.softmax(logits.float(), dim=-1)
    top_w, top_idx = top_k(probs, cfg.top_k)               # (G, n, k)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)

    i32 = torch.int32
    counts = torch.zeros((G, X), dtype=i32, device=logits.device)
    dispatch = torch.zeros((G, n, X, C), dtype=torch.bfloat16,
                           device=logits.device)
    combine = torch.zeros((G, n, X, C), dtype=torch.float32,
                          device=logits.device)
    for j in range(cfg.top_k):
        oh = _one_hot(top_idx[:, :, j], X, i32)            # (G, n, X)
        pos_in_expert = torch.cumsum(oh, dim=1, dtype=i32) - oh \
            + counts[:, None, :]
        pos = torch.sum(oh * pos_in_expert, dim=-1, dtype=i32)  # (G, n)
        keep = pos < C
        pos_oh = _one_hot(pos, C, torch.float32) \
            * keep[..., None].float()                      # (G, n, C)
        d_j = oh.float()[..., None] * pos_oh[:, :, None, :]
        dispatch = dispatch + d_j.to(torch.bfloat16)
        combine = combine + d_j * top_w[:, :, j][..., None, None]
        counts = counts + torch.sum(oh, dim=1, dtype=i32)

    # GShard aux loss: mean(fraction routed * mean prob) * X
    frac = torch.mean(_one_hot(top_idx[:, :, 0], X, torch.float32), dim=1)
    aux = torch.mean(frac * torch.mean(probs, dim=1)) * X * X
    return dispatch, combine.to(torch.bfloat16), aux


def moe_ffn(x: torch.Tensor, params: Dict, cfg: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, E) -> (y, aux_loss, expert_token_counts (X,) float32).

    The per-expert token counts feed Chipmink's active-variable filter:
    experts with zero routed tokens this window received no gradient, so
    their parameter/optimizer pods are provably clean.
    """
    B, S, E = x.shape
    G = min(cfg.n_groups, B * S)
    n = (B * S) // G
    # (B, S) -> (B, S/n, n) -> (G, n): groups of whole batch rows keep a
    # batch-sharded x sharded
    tokens = reshape(reshape(x, B, S // n, n, E), G, n, E) if S % n == 0 \
        else reshape(x, G, n, E)
    logits = dense(tokens, params["router"])               # (G, n, X) f32
    dispatch, combine, aux = router_dispatch(logits, cfg)
    # dispatch: (G, n, X, C) x (G, n, E) -> (X, G, C, E); the X-dim
    # constraint turns the reshard into the expert all-to-all
    expert_in = einsum("gnxc,gne->xgce", dispatch,
                             tokens.to(torch.bfloat16))
    expert_in = constrain(expert_in, (cfg.ep_logical, None, None, None))
    Xn, Gn, Cn, En = expert_in.shape
    ein = reshape(expert_in, Xn, Gn * Cn, En)
    g = torch.bmm(ein, params["w_gate"])
    u = torch.bmm(ein, params["w_up"])
    h = silu(g) * u
    eout = reshape(torch.bmm(h, params["w_down"]), Xn, Gn, Cn, En)
    y = einsum("xgce,gnxc->gne", eout, combine)
    y = reshape(y, B, S, E).to(x.dtype)

    if cfg.n_shared:
        y = y + swiglu(x, params["shared_gate"], params["shared_up"],
                       params["shared_down"])

    counts = torch.sum(dispatch.float(), dim=(0, 1, 3))    # (X,)
    return y, aux, counts
