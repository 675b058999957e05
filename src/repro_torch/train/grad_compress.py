"""Gradient compression: int8 block quantization with error feedback.
The port of `repro.train.grad_compress`'s per-shard transform.

`quantize_dequantize(g, ef)` quantizes each block of 256 values to int8
with one float32 scale (max |x| / 127), dequantizes, and carries what was
lost into the next step as a bf16 error-feedback residual.
`compressed_psum(x, group)` is the reference's int8 psum over a mesh
axis, as `torch.distributed` collectives over that axis's process group.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .tree import tree_map, tree_unzip

BLOCK = 256


def _blockify(x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    pad = (-n) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), n, pad


def quantize(x: torch.Tensor):
    blocks, n, _pad = _blockify(x)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 \
        + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float(), n


def dequantize(q: torch.Tensor, scale: torch.Tensor, n: int, shape,
               dtype: torch.dtype) -> torch.Tensor:
    x = (q.float() * scale).reshape(-1)[:n]
    return x.reshape(shape).to(dtype)


def quantize_dequantize(g: torch.Tensor, ef: Optional[torch.Tensor] = None):
    """Returns (g_hat, new_error_feedback)."""
    x = g.float()
    if ef is not None:
        x = x + ef.float()
    q, scale, n = quantize(x)
    x_hat = dequantize(q, scale, n, g.shape, torch.float32)
    new_ef = (x - x_hat).to(torch.bfloat16)
    return x_hat.to(g.dtype), new_ef


def tree_quantize_dequantize(grads: Any, ef_tree: Optional[Any]):
    if ef_tree is None:
        ef_tree = tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.bfloat16, device=g.device), grads)
    return tree_unzip(tree_map(quantize_dequantize, grads, ef_tree), 2)


def compressed_psum(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """An int8-quantized sum of `x` over the ranks of `group` (a mesh
    axis's group, ``mesh.get_group(axis)``; None: the default group): the
    int8 payloads summed as int32 and the float32 scales reduced by max,
    then dequantized (the wire format is 8.125 bits/element vs 16 for
    bf16).  Every rank gets the same result."""
    import torch.distributed as dist
    q, scale, n = quantize(x)
    acc = q.to(torch.int32)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    s = scale.clone()
    dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)  # shared scale
    out = (acc.float() * s).reshape(-1)[:n]
    return out.reshape(x.shape).to(x.dtype)
