"""Attention: grouped-query (GQA/MQA), causal / sliding-window, with a
q-chunked path for long prefill, plus single-token decode attention over
(optionally ring-buffered) KV caches.  The port of
`repro.models.attention`.

Layout conventions:
    q        (B, S, Hq,  D)
    k, v     (B, T, Hkv, D)      Hq = Hkv * G
Scores are computed grouped: KV heads are never materialized Hq-wide.
Scores and softmax run in float32; the weights are cast to the value
dtype before the weighted sum, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel.sharding import (constrain, einsum, from_local, is_dtensor,
                                 reshape, shard_offset)
from .layers import round_to

NEG_INF = -1e30


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(S, T) additive bias: 0 allowed / NEG_INF masked."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok = ok & (diff >= 0)
    if window is not None:
        ok = ok & (diff < window)
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_chunk: Optional[int] = None, q_offset: int = 0,
              mixed: bool = False) -> torch.Tensor:
    """Full (or q-chunked) grouped attention.

    q: (B, S, Hq, D); k, v: (B, T, Hkv, D).  Returns (B, S, Hq, D).
    `q_offset` positions the queries within the key timeline.  `q_chunk`
    bounds each step's score buffer to (B, Hq, q_chunk, T).  `mixed=True`
    scales Q in its own dtype (bf16) and multiplies the bf16 operands with
    float32 accumulation, the reference's ``preferred_element_type=
    float32``.  DTensor operands run shard by shard (`_attention_shards`).
    """
    if is_dtensor(q):
        return _attention_shards(q, k, v, causal=causal, window=window,
                                 q_chunk=q_chunk, mixed=mixed)
    B, S, Hq, D = q.shape
    _, T, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    scale = D ** -0.5
    k_pos = torch.arange(T, device=q.device)
    kf = k.float()

    def block(q_blk: torch.Tensor, offset: int) -> torch.Tensor:
        s = q_blk.shape[1]
        if mixed:
            qs = q_blk * round_to(scale, q_blk.dtype)
            scores = torch.einsum("bsngd,btnd->bngst", qs.float(), kf)
        else:
            scores = torch.einsum("bsngd,btnd->bngst",
                                  q_blk.float() * scale, kf)
        q_pos = torch.arange(s, device=q.device) + (q_offset + offset)
        bias = _mask_bias(q_pos, k_pos, causal=causal, window=window)
        scores = scores + bias[None, None, None, :, :]
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum("bngst,btnd->bsngd", w.to(v.dtype), v)
        return o.reshape(B, s, Hq, D)

    if q_chunk is None or S <= q_chunk:
        return block(qg, 0)
    outs = []
    off = 0
    while off < S:
        size = min(q_chunk, S - off)
        # the reference re-pins sequence-parallel sharding on the chunk;
        # here DTensor queries were split before this loop
        # (`_attention_shards`), so the chunk is a rank's own tensor
        blk = constrain(qg[:, off:off + size],
                        ("batch", "seq_model", None, None, None))
        outs.append(block(blk, off))
        off += size
    return torch.cat(outs, dim=1)


def _attention_shards(q, k, v, **kw) -> torch.Tensor:
    """Sequence-parallel attention over DTensors: queries sharded over
    batch and sequence (the reference's ``("batch", "seq_model", None,
    None)``), keys and values over batch alone; each rank attends its own
    query rows against the whole key timeline, at its offset in it."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    qp = [p if p in (Shard(0), Shard(1)) else Replicate()
          for p in q.placements]
    kvp = [p if p == Shard(0) else Replicate() for p in qp]
    q = q.redistribute(mesh, qp)
    k, v = k.redistribute(mesh, kvp), v.redistribute(mesh, kvp)
    o = attention(q.to_local(), k.to_local(), v.to_local(),
                  q_offset=shard_offset(q, 1), **kw)
    return from_local(o, mesh, qp, q.shape)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """One-token attention over a KV cache.

    q: (B, 1, Hq, D); caches: (B, T, Hkv, D); lengths: (B,) valid entries
    (a device tensor: no host sync).  For ring-buffered caches `lengths`
    saturates at T; softmax is order-invariant, so the ring needs no
    unrotation (RoPE was applied before insertion).
    """
    B, _, Hq, D = q.shape
    _, T, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    qg = reshape(q, B, Hkv, G, D)
    scale = D ** -0.5
    scores = einsum("bngd,btnd->bngt", qg.float() * scale,
                          k_cache.float())
    idx = torch.arange(T, device=q.device)[None, :]          # (1, T)
    valid = idx < lengths[:, None]                            # (B, T)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    o = einsum("bngt,btnd->bngd", w.to(v_cache.dtype), v_cache)
    return reshape(o, B, 1, Hq, D)
