"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427]:
the port of `repro.models.rglru`.

The Real-Gated Linear Recurrent Unit is a *diagonal* linear recurrence

    r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
    a_t = exp(-c * softplus(Λ) * r_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

run over the whole sequence by `ssm.linear_scan` (the reference's
`jax.lax.associative_scan`, in its order).  The recurrence sits inside
Griffin's recurrent block: linear in-proj to a gate branch and a
recurrent branch, temporal conv1d (k=4), the RG-LRU, gated merge,
out-proj.  These are the dense-gate forms; `transformer` uses the
block-diagonal gates of its own `_rg_lru_blockdiag`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .layers import dense, gelu_tanh, sigmoid, softplus
from .ssm import causal_conv1d, conv_step, linear_scan

_C = 8.0  # Griffin's fixed constant


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int
    d_conv: int = 4


def lru_coeffs(r: torch.Tensor, i: torch.Tensor, lam: torch.Tensor,
               x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, sqrt(1 - a²) · i · x) in float32 from the gates r, i (float32),
    the raw Λ and the input x."""
    lam = softplus(lam.float())
    a = torch.exp(-_C * lam[None, None, :] * r)     # (B,L,W)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i \
        * x.float()
    return a, gated


def _gates(params: Dict, x: torch.Tensor):
    r = sigmoid(dense(x, params["w_a"]).float())
    i = sigmoid(dense(x, params["w_x"]).float())
    return lru_coeffs(r, i, params["lambda"], x)


def rg_lru(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, L, W) -> (B, L, W) via the scan."""
    a, b = _gates(params, x)
    _, h = linear_scan(a, b, dim=1)
    return h.to(x.dtype)


def rg_lru_decode_step(params: Dict, x: torch.Tensor, state: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, 1, W); state: (B, W) -> (y (B,1,W), new state)."""
    a, b = _gates(params, x)
    new = a[:, 0] * state + b[:, 0]
    return new[:, None].to(x.dtype), new


def recurrent_block(params: Dict, x: torch.Tensor,
                    cfg: RGLRUConfig) -> torch.Tensor:
    """Griffin recurrent block.  x: (B, L, d_model)."""
    gate = gelu_tanh(dense(x, params["in_gate"]))
    rec = dense(x, params["in_rec"])
    rec = causal_conv1d(rec, params["conv_w"], params["conv_b"])
    rec = rg_lru(params, rec)
    return dense(rec * gate, params["out_proj"])


def recurrent_block_decode(params: Dict, x: torch.Tensor,
                           conv_state: torch.Tensor,
                           lru_state: torch.Tensor, cfg: RGLRUConfig):
    """Single-token recurrent block.  conv_state: (B, K-1, W); lru_state:
    (B, W) -> (y, new conv window, new LRU state); the inputs are not
    written."""
    gate = gelu_tanh(dense(x, params["in_gate"]))
    rec = dense(x, params["in_rec"])                 # (B,1,W)
    window = torch.cat([conv_state, rec], dim=1)
    rec = conv_step(window, params["conv_w"], params["conv_b"])
    rec = rec[:, None].to(x.dtype)
    y, new_lru = rg_lru_decode_step(params, rec, lru_state)
    out = dense(y * gate, params["out_proj"])
    return out, window[:, 1:], new_lru
