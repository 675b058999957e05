"""Shared model layers: norms, projections, rotary embeddings (RoPE and
Qwen2-VL's multimodal M-RoPE), MLPs.

The port of `repro.models.layers`.  All layers are pure functions over
nested dicts of tensors.  Parameter shapes, dtypes, logical sharding axes
and initializers are declared once via `ParamDef` tables (built in
`transformer.param_defs`); the same table drives real initialization,
the abstract `TensorSpec` trees of the dry-run (no allocation) and the
logical-axes trees of the sharding rules.

Casts follow the reference one by one, since a tolerance hides a wrong
cast only at small widths: norms and RoPE compute in float32 and cast
back, `dense` multiplies in the operands' dtype (bf16 in, bf16 out;
mixed operands promoted as `jnp.einsum` promotes them) and adds its bias
in that dtype, and the activations round every step to bf16 as the
reference's do.
"""
from __future__ import annotations

import dataclasses
import math
import struct
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..parallel.sharding import einsum, from_local, is_dtensor, shard_offset

Path = Tuple[str, ...]


class TensorSpec(NamedTuple):
    """An abstract tensor (the reference's `jax.ShapeDtypeStruct`): the
    leaves of the abstract parameter, input and cache trees."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    dtype: Optional[torch.dtype]      # None -> the caller's dtype (bf16)
    axes: Tuple[Optional[str], ...]   # logical axis names, len == ndim
    init: str = "normal"              # normal | zeros | ones | embed

    def scale(self) -> float:
        if self.init == "embed":
            # unit-variance activations after the sqrt(d_model) input scale,
            # ~N(0,1) logits under tied embeddings
            return 1.0 / float(self.shape[-1]) ** 0.5
        fan_in = self.shape[0] if len(self.shape) >= 1 else 1
        if len(self.shape) >= 2:
            fan_in = math.prod(self.shape[:-1])
        return 1.0 / max(1.0, float(fan_in)) ** 0.5


ParamDefs = Dict[Path, ParamDef]


def init_params(defs: ParamDefs, generator: torch.Generator, *,
                device: Any, dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Materialize parameters from defs, in sorted path order: a float32
    normal draw times `ParamDef.scale()`, then cast.  The draws come from
    `generator` (on `device`), so they are not the reference's: tests
    carry the reference's parameters over with `convert`."""
    flat: Dict[Path, torch.Tensor] = {}
    for path, d in sorted(defs.items()):
        dt = d.dtype or dtype
        if d.init == "zeros":
            v = torch.zeros(d.shape, dtype=dt, device=device)
        elif d.init == "ones":
            v = torch.ones(d.shape, dtype=dt, device=device)
        else:
            v = (torch.randn(d.shape, generator=generator, device=device,
                             dtype=torch.float32) * d.scale()).to(dt)
        flat[path] = v
    return unflatten(flat)


def abstract_params(defs: ParamDefs,
                    dtype: torch.dtype = torch.bfloat16) -> Dict:
    """`TensorSpec` tree (dry-run: no allocation)."""
    return unflatten({p: TensorSpec(tuple(d.shape), d.dtype or dtype)
                      for p, d in defs.items()})


def logical_axes(defs: ParamDefs) -> Dict:
    return unflatten({p: d.axes for p, d in defs.items()})


def unflatten(flat: Dict[Path, Any]) -> Dict:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        cur = out
        for p in path[:-1]:
            cur = cur.setdefault(p, {})
        cur[path[-1]] = v
    return out


def round_to(x: float, dtype: torch.dtype) -> float:
    """The Python float `x` rounded to nearest-even in the float `dtype`,
    on the host: equal to ``float(torch.tensor(x, dtype=dtype))`` but with
    no tensor, so it also runs on meta tensors."""
    if dtype == torch.float64:
        return float(x)
    if dtype == torch.float16:
        return struct.unpack("<e", struct.pack("<e", x))[0]
    f32 = struct.unpack("<f", struct.pack("<f", x))[0]
    if dtype != torch.bfloat16:
        return f32
    bits = struct.unpack("<I", struct.pack("<f", f32))[0]
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", bits))[0]


# ---------------------------------------------------------------------------
# norms / projections
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b).  Operands of two dtypes are promoted first, as
    `jnp.einsum` does: a bf16 token times the MoE router's float32
    weight is a float32 product."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def embedding(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows of `table` (V, E) at `tokens`.  For a DTensor table,
    vocab-parallel: the table keeps only its vocab shards (its other dims
    gathered), every rank reads the tokens its shard holds (zero rows for
    the rest), and the rows sum over the vocab's mesh dims (a `Partial`
    placement there); the tokens keep their shards on the other mesh
    dims."""
    if not is_dtensor(table):
        return torch.nn.functional.embedding(tokens, table)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tp = [p if p == Shard(0) else Replicate() for p in table.placements]
    table = table.redistribute(mesh, tp)
    kp = [Replicate() if t == Shard(0) or not isinstance(p, Shard) else p
          for t, p in zip(tp, tokens.placements)]
    tokens = tokens.redistribute(mesh, kp)
    local = table.to_local()
    rel = tokens.to_local() - shard_offset(table, 0)
    owned = ((rel >= 0) & (rel < local.shape[0]))[..., None]
    rows = torch.nn.functional.embedding(
        torch.clamp(rel, 0, local.shape[0] - 1), local)
    rows = torch.where(owned, rows, torch.zeros((), dtype=rows.dtype,
                                                device=rows.device))
    out = [Partial() if t == Shard(0) else p for t, p in zip(tp, kp)]
    return from_local(rows, mesh, out, tuple(tokens.shape) + table.shape[1:])


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a (..., K) `x` and a (K, N) `w`; DTensors multiply
    shard by shard (`sharding.einsum`)."""
    if is_dtensor(x) or is_dtensor(w):
        lead = "abcdefgh"[:x.ndim - 1]
        return einsum(f"{lead}k,kn->{lead}n", x, w)
    return torch.matmul(x, w)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid` as XLA lowers it on the reference's CPU: in bf16,
    1 / (1 + exp(-x)) with every step rounded to bf16 (bit-equal); in
    float32, `torch.sigmoid` (the closer of the two there, within an
    ulp)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`: x * `sigmoid`(x), each step in x's dtype.  (`F.silu`
    rounds once; with it the decode step falls outside the tests'
    tolerance.)"""
    return x * sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, the reference's ``logaddexp(x, 0)``: in bf16,
    max(x, 0) + log1p(exp(-|x|)) with every step rounded to bf16
    (bit-equal); in float32, `torch.logaddexp` (within an ulp)."""
    if x.dtype == torch.float32:
        return torch.logaddexp(x, torch.zeros((), device=x.device))
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu(x, approximate=True)` step by step in x's dtype, its
    constants rounded to that dtype first, as the reference's weak-typed
    Python floats are (bit-equal in bf16)."""
    c = round_to(math.sqrt(2 / math.pi), x.dtype)
    a = round_to(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + a * (x ** 3))))
    return x * cdf


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = dense(x, w_gate)
    u = dense(x, w_up)
    return dense(silu(g) * u, w_down)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: Optional[torch.Tensor],
             w_down: torch.Tensor,
             b_down: Optional[torch.Tensor]) -> torch.Tensor:
    h = gelu_tanh(dense(x, w_up, b_up))
    return dense(h, w_down, b_down)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, *,
               device: Any = None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)           # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Split-half
    convention: the first and second halves of D form the rotated pairs."""
    D = x.shape[-1]
    inv = rope_freqs(D, theta, device=x.device)               # (D/2,)
    ang = positions[..., None].float() * inv                  # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: Sequence[int],
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL multimodal rotary embedding [arXiv:2409.12191].

    x: (B, S, H, D); positions: (3, B, S): temporal / height / width ids.
    The D/2 frequency lanes are partitioned into `sections` (t, h, w);
    each section rotates by its own position stream.
    """
    D = x.shape[-1]
    if sum(sections) != D // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum "
                         f"to head_dim / 2 = {D // 2}")
    inv = rope_freqs(D, theta, device=x.device)               # (D/2,)
    pieces = []
    start = 0
    for sec, pos in zip(sections, positions):
        pieces.append(pos[..., None].float() * inv[start:start + sec])
        start += sec
    ang = torch.cat(pieces, dim=-1)                           # (B, S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
