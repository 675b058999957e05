"""Mamba-1 selective SSM block (falcon-mamba-7b) [arXiv:2312.00752,
2410.05355]: the port of `repro.models.ssm`.

The recurrence h_t = Ā_t h_{t-1} + B̄_t x_t is solved in time chunks:
within a chunk by `linear_scan`, the reference's
`jax.lax.associative_scan` rebuilt in the same odd-even order (so float32
rounds as the reference's does, op for op), and across chunks by a
Python loop carrying the (B, E, N) state, as the reference's `lax.scan`
does.  The C-projection runs inside the chunk loop, so the (B, chunk, E,
N) hidden states stay transient.  A cumulative product with a division
would be shorter but underflows: Ā is a product of exp(dt·A) < 1.

Jamba's mixer normalises dt, B and C with RMSNorms after x_proj
(`SSMConfig.inner_norms`, in `_ssm_coeffs`, which the block and the
decode step share).

Decode is a single state update; `mamba_decode_step` returns the new
conv window and SSM state, and the caller (`transformer.decode_step`)
copies them into the cache's own tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..parallel.sharding import einsum
from .layers import dense, rms_norm, silu, softplus


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_inner: int           # E_in = expand * d_model
    d_state: int = 16      # N
    d_conv: int = 4
    dt_rank: int = 256
    chunk: int = 64        # time chunk for the parallel scan
    inner_norms: bool = False  # Jamba: RMSNorms of dt, B and C


def _along(t: torch.Tensor, dim: int, sl: slice) -> torch.Tensor:
    return t[(slice(None),) * dim + (sl,)]


def _interleave(even: torch.Tensor, odd: torch.Tensor,
                dim: int) -> torch.Tensor:
    """e0, o0, e1, o1, ... along `dim` (len(even) is len(odd) or one
    more)."""
    n = odd.shape[dim]
    pairs = torch.stack([even.narrow(dim, 0, n), odd], dim=dim + 1)
    out = pairs.flatten(dim, dim + 1)
    if even.shape[dim] > n:
        out = torch.cat([out, even.narrow(dim, n, 1)], dim=dim)
    return out


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                dim: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the pairs (a_t, b_t) along `dim` under
    (a1, b1) . (a2, b2) = (a2 * a1, a2 * b1 + b2): the second result is
    h_t = a_t h_{t-1} + b_t from h_{-1} = 0.  The order is
    `jax.lax.associative_scan`'s: combine adjacent pairs, scan those
    recursively, then fill in the even positions; every product and sum
    is one op, rounded once, as the reference's are.  log2(T) levels of
    elementwise ops; differentiable."""
    n = a.shape[dim]
    if n < 2:
        return a, b
    ev, od = slice(0, n - 1, 2), slice(1, None, 2)
    a_e, b_e = _along(a, dim, ev), _along(b, dim, ev)
    a_o, b_o = _along(a, dim, od), _along(b, dim, od)
    sa, sb = linear_scan(a_o * a_e, a_o * b_e + b_o, dim)
    nxt = slice(2, None, 2)
    a_n, b_n = _along(a, dim, nxt), _along(b, dim, nxt)
    if n % 2 == 0:
        sa_, sb_ = sa.narrow(dim, 0, sa.shape[dim] - 1), \
            sb.narrow(dim, 0, sb.shape[dim] - 1)
    else:
        sa_, sb_ = sa, sb
    ea = torch.cat([a.narrow(dim, 0, 1), a_n * sa_], dim=dim)
    eb = torch.cat([b.narrow(dim, 0, 1), a_n * sb_ + b_n], dim=dim)
    return _interleave(ea, sa, dim), _interleave(eb, sb, dim)


def _ssm_coeffs(params: Dict, x: torch.Tensor, cfg: SSMConfig):
    """x: (B, L, E_in) -> Ā (B,L,E,N), B̄x (B,L,E,N), C (B,L,N), float32."""
    bl = dense(x, params["x_proj"])                   # (B,L,dt_rank+2N)
    R, N = cfg.dt_rank, cfg.d_state
    dt, Bc, Cc = torch.split(bl, [R, N, bl.shape[-1] - R - N], dim=-1)
    if cfg.inner_norms:
        dt = rms_norm(dt, params["dt_norm"])
        Bc = rms_norm(Bc, params["b_norm"])
        Cc = rms_norm(Cc, params["c_norm"])
    dt = softplus(dense(dt, params["dt_proj"])
                  + params["dt_bias"].to(x.dtype))    # (B,L,E)
    A = -torch.exp(params["A_log"].float())           # (E,N)
    dt32 = dt.float()
    Abar = torch.exp(dt32[..., None] * A[None, None])
    Bx = (dt32[..., None] * Bc.float()[:, :, None, :]
          * x.float()[..., None])
    return Abar, Bx, Cc.float()


def _scan_chunk(Abar: torch.Tensor, Bx: torch.Tensor, h0: torch.Tensor):
    """Scan within one chunk from the carried state h0 (B, E, N):
    (all states (B, ck, E, N), the last state)."""
    b0 = torch.cat([Bx[:, :1] + (Abar[:, 0] * h0)[:, None], Bx[:, 1:]],
                   dim=1)
    _, h = linear_scan(Abar, b0, dim=1)
    return h, h[:, -1]


def selective_scan(params: Dict, x: torch.Tensor,
                   cfg: SSMConfig) -> torch.Tensor:
    """x: (B, L, E_in) -> y: (B, L, E_in).  Chunked scan with the
    C-projection fused into the chunk loop: materialized per-layer state
    is O(B·L·E), never O(B·L·E·N)."""
    B, L, E = x.shape
    Abar, Bx, C = _ssm_coeffs(params, x, cfg)
    ck = min(cfg.chunk, L)
    n_chunks = -(-L // ck)
    pad = n_chunks * ck - L
    if pad:
        Abar = F.pad(Abar, (0, 0, 0, 0, 0, pad), value=1.0)
        Bx = F.pad(Bx, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    h = torch.zeros((B, E, cfg.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c in range(n_chunks):
        sl = slice(c * ck, (c + 1) * ck)
        hs, h = _scan_chunk(Abar[:, sl], Bx[:, sl], h)
        ys.append(einsum("bken,bkn->bke", hs, C[:, sl]))
    y = torch.cat(ys, dim=1)[:, :L]
    y = y + x.float() * params["D"].float()
    return y.to(x.dtype)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time.  x: (B, L, E); w: (K, E).  The K
    taps are summed in order in x's dtype, as the reference's Python
    `sum`."""
    B, L, E = x.shape
    K = w.shape[0]
    # zeros before the first step (`F.pad`'s values; DTensor's pad rule
    # fails on a 2-D mesh in some torch releases)
    xp = torch.cat([torch.zeros((B, K - 1, E), dtype=x.dtype,
                                device=x.device), x], dim=1)
    y = sum(xp[:, i:i + L] * w[i][None, None, :] for i in range(K))
    return silu(y + b[None, None, :])


def mamba_block(params: Dict, x: torch.Tensor,
                cfg: SSMConfig) -> torch.Tensor:
    """Full mamba-1 mixer.  x: (B, L, d_model) -> (B, L, d_model)."""
    xz = dense(x, params["in_proj"])                   # (B,L,2*E_in)
    xin, z = torch.chunk(xz, 2, dim=-1)
    xin = causal_conv1d(xin, params["conv_w"], params["conv_b"])
    y = selective_scan(params, xin, cfg)
    y = y * silu(z)
    return dense(y, params["out_proj"])


# -- decode (single-token) ---------------------------------------------------

def conv_step(window: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """The causal conv at the newest position of ``window`` (B, K, E), in
    float32: silu(sum_k window_k * w_k + b) -> (B, E)."""
    conv = einsum("bke,ke->be", window.float(), w.float())
    return silu(conv + b.float())


def mamba_decode_step(params: Dict, x: torch.Tensor,
                      conv_state: torch.Tensor, ssm_state: torch.Tensor,
                      cfg: SSMConfig):
    """x: (B, 1, d_model); conv_state: (B, K-1, E_in); ssm_state:
    (B, E_in, N) -> (y (B,1,d_model), new conv window, new SSM state).
    The inputs are not written; the new window is a view of a fresh
    tensor."""
    xz = dense(x, params["in_proj"])
    xin, z = torch.chunk(xz, 2, dim=-1)                # (B,1,E_in)
    window = torch.cat([conv_state, xin], dim=1)       # (B,K,E_in)
    xin1 = conv_step(window, params["conv_w"], params["conv_b"])[:, None]
    xin1 = xin1.to(x.dtype)
    Abar, Bx, C = _ssm_coeffs(params, xin1, cfg)       # (B,1,E,N)
    new_state = Abar[:, 0] * ssm_state + Bx[:, 0]      # (B,E,N)
    y = einsum("ben,bn->be", new_state, C[:, 0])
    y = y + xin1[:, 0].float() * params["D"].float()
    y = (y.to(x.dtype) * silu(z[:, 0]))[:, None]
    out = dense(y, params["out_proj"])
    return out, window[:, 1:], new_state
