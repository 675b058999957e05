"""Decoder stack of the dense family (qwen1.5-0.5b, qwen2.5-14b,
starcoder2-3b, starcoder2-7b): the port of `repro.models.transformer`
for the `attn` / `attn_local` mixers and the `swiglu` / `gelu` / `none`
FFNs, without the reference's sharding constraints.

Each layer is (mixer, ffn) from `cfg.layer_plan()`.  Parameters are
declared once in `param_defs` (shape + dtype + logical axes + init) and
live in a nested dict of tensors whose paths are the reference's, so a
Chipmink save of either package's state names the same leaves.

Serving: `decode_step` writes each new token's K and V into the cache
tensors in place (`index_copy_` at slot ``pos % T``) and keeps ``pos``,
the slot and the valid lengths on the device, so a step makes no host
sync.  The returned cache holds the same K/V tensors and a new ``pos``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from .attention import attention, decode_attention
from .layers import (ParamDef, ParamDefs, apply_rope, dense, gelu_mlp,
                     layer_norm, rms_norm, round_to, swiglu)

MIXERS = ("attn", "attn_local")
FFNS = ("swiglu", "gelu", "none")


def not_ported(what: str, cfg: ArchConfig) -> NotImplementedError:
    return NotImplementedError(
        f"{what} of {cfg.arch_id} ({cfg.family} family) is not ported yet: "
        f"ROADMAP.md section 1, item 2 (the other model families)")


def layer_plan(cfg: ArchConfig) -> List[Tuple[str, str]]:
    """`cfg.layer_plan()`, raising for a mixer, FFN or frontend the port
    does not have yet."""
    if cfg.vlm is not None:
        raise not_ported("the vision frontend (M-RoPE)", cfg)
    if cfg.encoder is not None:
        raise not_ported("the encoder", cfg)
    plan = cfg.layer_plan()
    for mixer, ffn in plan:
        if mixer not in MIXERS:
            raise not_ported(f"mixer {mixer!r}", cfg)
        if ffn not in FFNS:
            raise not_ported(f"FFN {ffn!r}", cfg)
    return plan


# ---------------------------------------------------------------------------
# parameter declaration
# ---------------------------------------------------------------------------


def _norm_defs(path: Tuple[str, ...], cfg: ArchConfig) -> ParamDefs:
    E = cfg.d_model
    defs: ParamDefs = {path + ("scale",): ParamDef(
        (E,), torch.float32, (None,), "zeros" if cfg.norm == "rms" else "ones")}
    if cfg.norm == "ln":
        defs[path + ("bias",)] = ParamDef((E,), torch.float32, (None,),
                                          "zeros")
    return defs


def _attn_defs(p: Tuple[str, ...], cfg: ArchConfig) -> ParamDefs:
    E, Hq, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    defs: ParamDefs = {
        p + ("wq",): ParamDef((E, Hq * D), None, ("embed", "heads")),
        p + ("wk",): ParamDef((E, Hkv * D), None, ("embed", "kv")),
        p + ("wv",): ParamDef((E, Hkv * D), None, ("embed", "kv")),
        p + ("wo",): ParamDef((Hq * D, E), None, ("heads", "embed")),
    }
    if cfg.qkv_bias:
        defs[p + ("bq",)] = ParamDef((Hq * D,), None, ("heads",), "zeros")
        defs[p + ("bk",)] = ParamDef((Hkv * D,), None, ("kv",), "zeros")
        defs[p + ("bv",)] = ParamDef((Hkv * D,), None, ("kv",), "zeros")
    return defs


def _ffn_defs(p: Tuple[str, ...], cfg: ArchConfig, kind: str) -> ParamDefs:
    E, F = cfg.d_model, cfg.d_ff
    if kind == "swiglu":
        return {
            p + ("w_gate",): ParamDef((E, F), None, ("embed", "ffn")),
            p + ("w_up",): ParamDef((E, F), None, ("embed", "ffn")),
            p + ("w_down",): ParamDef((F, E), None, ("ffn", "embed")),
        }
    return {                                                  # gelu
        p + ("w_up",): ParamDef((E, F), None, ("embed", "ffn")),
        p + ("b_up",): ParamDef((F,), None, ("ffn",), "zeros"),
        p + ("w_down",): ParamDef((F, E), None, ("ffn", "embed")),
        p + ("b_down",): ParamDef((E,), None, (None,), "zeros"),
    }


def param_defs(cfg: ArchConfig) -> ParamDefs:
    E, V = cfg.d_model, cfg.vocab
    plan = layer_plan(cfg)
    defs: ParamDefs = {
        ("embed",): ParamDef((V, E), None, ("vocab", "embed"), "embed"),
    }
    if not cfg.tie_embeddings:
        defs[("lm_head",)] = ParamDef((E, V), None, ("embed", "vocab"))
    defs.update(_norm_defs(("final_norm",), cfg))
    for i, (_mixer, ffn) in enumerate(plan):
        p = ("layers", str(i))
        defs.update(_norm_defs(p + ("norm1",), cfg))
        defs.update(_attn_defs(p + ("attn",), cfg))
        if ffn != "none":
            defs.update(_norm_defs(p + ("norm2",), cfg))
            defs.update(_ffn_defs(p + ("ffn",), cfg, ffn))
    return defs


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def _norm(x: torch.Tensor, params: Dict, cfg: ArchConfig) -> torch.Tensor:
    if cfg.norm == "rms":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params["bias"])


def _window(cfg: ArchConfig, mixer: str) -> Optional[int]:
    return cfg.rglru.attn_window if mixer == "attn_local" \
        else cfg.sliding_window


def _ffn(params: Dict, x: torch.Tensor, ffn: str) -> torch.Tensor:
    if ffn == "swiglu":
        return swiglu(x, params["w_gate"], params["w_up"], params["w_down"])
    return gelu_mlp(x, params["w_up"], params["b_up"], params["w_down"],
                    params["b_down"])


def _qkv(params: Dict, x: torch.Tensor, cfg: ArchConfig):
    B, S, _ = x.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = dense(x, params["wq"], params.get("bq")).reshape(B, S, Hq, D)
    k = dense(x, params["wk"], params.get("bk")).reshape(B, S, Hkv, D)
    v = dense(x, params["wv"], params.get("bv")).reshape(B, S, Hkv, D)
    return q, k, v


def _attn_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                positions: torch.Tensor, window: Optional[int],
                q_chunk: Optional[int]) -> torch.Tensor:
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=True, window=window, q_chunk=q_chunk)
    return dense(o.reshape(B, S, cfg.n_heads * cfg.hd), params["wo"])


def _layer_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig, mixer: str,
                 ffn: str, *, positions: torch.Tensor,
                 q_chunk: Optional[int]) -> torch.Tensor:
    h = _norm(x, params["norm1"], cfg)
    h = _attn_apply(params["attn"], h, cfg, positions=positions,
                    window=_window(cfg, mixer), q_chunk=q_chunk)
    x = x + h
    if ffn != "none":
        x = x + _ffn(params["ffn"], _norm(x, params["norm2"], cfg), ffn)
    return x


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------


def embed_tokens(params: Dict, tokens: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """Rows of the embedding, in bf16, times sqrt(d_model) rounded to bf16
    (the reference multiplies two bf16 values)."""
    x = torch.nn.functional.embedding(tokens, params["embed"])
    return x.to(torch.bfloat16) * round_to(math.sqrt(cfg.d_model),
                                           torch.bfloat16)


def logits_from(params: Dict, x: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x, head)


# ---------------------------------------------------------------------------
# top level: forward / prefill / decode
# ---------------------------------------------------------------------------


def forward(params: Dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            q_chunk: Optional[int] = None,
            remat: bool = False) -> torch.Tensor:
    """Full-sequence forward -> hidden (B, S, E), after the final norm.
    ``remat`` checkpoints each layer: its activations are recomputed in
    the backward pass instead of kept."""
    plan = layer_plan(cfg)
    _, S = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device)
    for i, (mixer, ffn) in enumerate(plan):
        lp = params["layers"][str(i)]
        kw = dict(positions=positions, q_chunk=q_chunk)
        if remat:
            x = checkpoint(_layer_apply, lp, x, cfg, mixer, ffn,
                           use_reentrant=False, **kw)
        else:
            x = _layer_apply(lp, x, cfg, mixer, ffn, **kw)
    return _norm(x, params["final_norm"], cfg)


def sharded_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean of logsumexp minus the label's logit, in float32.  The
    reference picks the label's logit with a one-hot einsum (which never
    gathers a model-sharded vocab); on one device a gather gives the same
    float32 value."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)                             # (B, S)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]   # (B, S)
    return torch.mean(lse - ll)


def loss_fn(params: Dict, batch: Dict, cfg: ArchConfig, *,
            q_chunk: Optional[int] = None,
            remat: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy.  batch: tokens, labels (B, S) int.
    Returns (loss, {"nll": loss})."""
    x = forward(params, batch["tokens"], cfg, q_chunk=q_chunk, remat=remat)
    loss = sharded_cross_entropy(logits_from(params, x, cfg),
                                 batch["labels"])
    return loss, {"nll": loss}


def prefill(params: Dict, batch: Dict, cfg: ArchConfig, *,
            q_chunk: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Process a full prompt -> (last-position logits (B, V), {}).  As in
    the reference, the serve loop fills caches decode-first."""
    x = forward(params, batch["tokens"], cfg, q_chunk=q_chunk)
    return logits_from(params, x[:, -1], cfg), {}


class CacheSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def cache_spec(cfg: ArchConfig, B: int, T: int) -> Dict:
    """Cache tree of `CacheSpec` leaves.  Windowed attention caches are
    ring buffers of min(T, window)."""
    layers: Dict[str, Dict] = {}
    Hkv, D = cfg.n_kv_heads, cfg.hd
    for i, (mixer, _ffn) in enumerate(layer_plan(cfg)):
        window = _window(cfg, mixer)
        Tw = T if window is None else min(T, window)
        layers[str(i)] = {
            "k": CacheSpec((B, Tw, Hkv, D), torch.bfloat16),
            "v": CacheSpec((B, Tw, Hkv, D), torch.bfloat16),
        }
    return {"layers": layers, "pos": CacheSpec((), torch.int32)}


def init_cache(cfg: ArchConfig, B: int, T: int, *, device: Any) -> Dict:
    spec = cache_spec(cfg, B, T)
    return {"layers": {i: {k: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device)
                           for k, s in lc.items()}
                       for i, lc in spec["layers"].items()},
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B, 1) -> (logits (B, V), cache).  The
    cache's K/V tensors are updated in place; ``pos`` is replaced."""
    pos = cache["pos"]
    x = embed_tokens(params, tokens, cfg)
    new_layers: Dict[str, Dict] = {}
    for i, (_mixer, ffn) in enumerate(layer_plan(cfg)):
        lp = params["layers"][str(i)]
        h = _norm(x, lp["norm1"], cfg)
        h, new_layers[str(i)] = _decode_attn(lp["attn"], h,
                                             cache["layers"][str(i)], pos,
                                             cfg)
        x = x + h
        if ffn != "none":
            x = x + _ffn(lp["ffn"], _norm(x, lp["norm2"], cfg), ffn)
    x = _norm(x, params["final_norm"], cfg)
    logits = logits_from(params, x[:, 0], cfg)
    return logits, {"layers": new_layers, "pos": pos + 1}


def _decode_attn(params: Dict, x: torch.Tensor, lcache: Dict,
                 pos: torch.Tensor, cfg: ArchConfig):
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg)
    p = pos.expand(B, 1)
    q = apply_rope(q, p, cfg.rope_theta)
    k = apply_rope(k, p, cfg.rope_theta)
    k_cache, v_cache = lcache["k"], lcache["v"]
    T = k_cache.shape[1]
    # ring buffer: a windowed cache (and a full one past T) overwrites
    # its oldest slot, as the reference's `jnp.mod(pos, T)`
    slot = torch.remainder(pos, T).to(torch.int64).view(1)
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    lengths = torch.clamp(pos + 1, max=T).expand(B)
    o = decode_attention(q, k_cache, v_cache, lengths)
    o = dense(o.reshape(B, 1, cfg.n_heads * cfg.hd), params["wo"])
    return o, {"k": k_cache, "v": v_cache}
