"""Whisper-style encoder-decoder backbone [arXiv:2212.04356]: the port of
`repro.models.whisper`.

The conv audio frontend is a stub, as in the reference: callers supply
frame embeddings (B, n_frames, d_model).  Sinusoidal positions are used
on both sides.

Decoder layers: causal self-attention (+ a ring-buffered K/V cache in
decode, written in place as `transformer.decode_step` writes its own) ->
cross-attention over the encoder output (the cross K/V is computed once
by `build_cross_cache`, carried in the cache and never rewritten) -> GELU
MLP.  The decode step's sinusoidal position is computed on the device
from the cache's 0-d ``pos``, so a step makes no host sync.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from .attention import attention, decode_attention
from .layers import ParamDef, ParamDefs, dense, gelu_mlp, layer_norm
from .transformer import (CacheSpec, ring_attend, sharded_cross_entropy,
                          step_cache)


def _ln_defs(p, E) -> ParamDefs:
    return {p + ("scale",): ParamDef((E,), torch.float32, (None,), "ones"),
            p + ("bias",): ParamDef((E,), torch.float32, (None,), "zeros")}


def _attn_defs(p, cfg: ArchConfig) -> ParamDefs:
    E, Hq, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        p + ("wq",): ParamDef((E, Hq * D), None, ("embed", "heads")),
        p + ("bq",): ParamDef((Hq * D,), None, ("heads",), "zeros"),
        p + ("wk",): ParamDef((E, Hkv * D), None, ("embed", "kv")),
        p + ("wv",): ParamDef((E, Hkv * D), None, ("embed", "kv")),
        p + ("bv",): ParamDef((Hkv * D,), None, ("kv",), "zeros"),
        p + ("wo",): ParamDef((Hq * D, E), None, ("heads", "embed")),
        p + ("bo",): ParamDef((E,), None, (None,), "zeros"),
    }


def _mlp_defs(p, cfg: ArchConfig) -> ParamDefs:
    E, F = cfg.d_model, cfg.d_ff
    return {
        p + ("w_up",): ParamDef((E, F), None, ("embed", "ffn")),
        p + ("b_up",): ParamDef((F,), None, ("ffn",), "zeros"),
        p + ("w_down",): ParamDef((F, E), None, ("ffn", "embed")),
        p + ("b_down",): ParamDef((E,), None, (None,), "zeros"),
    }


def param_defs(cfg: ArchConfig) -> ParamDefs:
    E, V = cfg.d_model, cfg.vocab
    defs: ParamDefs = {
        ("embed",): ParamDef((V, E), None, ("vocab", "embed"), "embed"),
        ("frame_proj",): ParamDef((E, E), None, ("embed", None)),
    }
    defs.update(_ln_defs(("enc_final_norm",), E))
    defs.update(_ln_defs(("final_norm",), E))
    for i in range(cfg.encoder.n_layers):
        p = ("encoder", str(i))
        defs.update(_ln_defs(p + ("norm1",), E))
        defs.update(_attn_defs(p + ("attn",), cfg))
        defs.update(_ln_defs(p + ("norm2",), E))
        defs.update(_mlp_defs(p + ("ffn",), cfg))
    for i in range(cfg.n_layers):
        p = ("layers", str(i))
        defs.update(_ln_defs(p + ("norm1",), E))
        defs.update(_attn_defs(p + ("attn",), cfg))
        defs.update(_ln_defs(p + ("normx",), E))
        defs.update(_attn_defs(p + ("xattn",), cfg))
        defs.update(_ln_defs(p + ("norm2",), E))
        defs.update(_mlp_defs(p + ("ffn",), cfg))
    return defs


def _inv_timescales(channels: int, device) -> torch.Tensor:
    lt = math.log(10000.0) / (channels // 2 - 1)
    return torch.exp(-lt * torch.arange(channels // 2, dtype=torch.float32,
                                        device=device))


def _sin_cos(ang: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoids(length: int, channels: int, *, device=None) -> torch.Tensor:
    """(length, channels) float32: sin then cos of each position times
    each inverse timescale."""
    inv = _inv_timescales(channels, device)
    pos = torch.arange(length, dtype=torch.float32, device=device)
    return _sin_cos(pos[:, None] * inv[None, :])


def _ln(x: torch.Tensor, p: Dict) -> torch.Tensor:
    return layer_norm(x, p["scale"], p["bias"])


def _mha(p: Dict, xq: torch.Tensor, xkv: torch.Tensor, cfg: ArchConfig, *,
         causal: bool, q_chunk: Optional[int] = None) -> torch.Tensor:
    B, S, _ = xq.shape
    T = xkv.shape[1]
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = dense(xq, p["wq"], p["bq"]).reshape(B, S, Hq, D)
    k = dense(xkv, p["wk"]).reshape(B, T, Hkv, D)
    v = dense(xkv, p["wv"], p["bv"]).reshape(B, T, Hkv, D)
    o = attention(q, k, v, causal=causal, q_chunk=q_chunk)
    return dense(o.reshape(B, S, Hq * D), p["wo"], p["bo"])


def _mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return gelu_mlp(x, p["w_up"], p["b_up"], p["w_down"], p["b_down"])


def encode(params: Dict, frames: torch.Tensor,
           cfg: ArchConfig) -> torch.Tensor:
    """frames: (B, F, E) stub embeddings -> encoder output (B, F, E)."""
    _, F, E = frames.shape
    x = dense(frames.to(torch.bfloat16), params["frame_proj"])
    x = x + sinusoids(F, E, device=x.device)[None].to(x.dtype)
    for i in range(cfg.encoder.n_layers):
        p = params["encoder"][str(i)]
        h = _ln(x, p["norm1"])
        x = x + _mha(p["attn"], h, h, cfg, causal=False)
        x = x + _mlp(p["ffn"], _ln(x, p["norm2"]))
    return _ln(x, params["enc_final_norm"])


def _decoder_layer(p: Dict, y: torch.Tensor, enc_out: torch.Tensor,
                   cfg: ArchConfig, q_chunk: Optional[int]) -> torch.Tensor:
    h = _ln(y, p["norm1"])
    y = y + _mha(p["attn"], h, h, cfg, causal=True, q_chunk=q_chunk)
    y = y + _mha(p["xattn"], _ln(y, p["normx"]), enc_out, cfg,
                 causal=False, q_chunk=q_chunk)
    return y + _mlp(p["ffn"], _ln(y, p["norm2"]))


def _embed(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.embedding(tokens, params["embed"]) \
        .to(torch.bfloat16)


def decode_train(params: Dict, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ArchConfig, *, q_chunk: Optional[int] = None,
                 remat: bool = True) -> torch.Tensor:
    _, S = tokens.shape
    x = _embed(params, tokens)
    x = x + sinusoids(S, cfg.d_model, device=x.device)[None].to(x.dtype)
    for i in range(cfg.n_layers):
        p = params["layers"][str(i)]
        if remat:
            x = checkpoint(_decoder_layer, p, x, enc_out, cfg, q_chunk,
                           use_reentrant=False)
        else:
            x = _decoder_layer(p, x, enc_out, cfg, q_chunk)
    return _ln(x, params["final_norm"])


def loss_fn(params: Dict, batch: Dict, cfg: ArchConfig, *,
            q_chunk: Optional[int] = None, remat: bool = True):
    """Next-token cross-entropy.  batch: frames (B, F, E), tokens, labels
    (B, S) int.  Returns (loss, {"nll": loss})."""
    enc_out = encode(params, batch["frames"], cfg)
    x = decode_train(params, batch["tokens"], enc_out, cfg, q_chunk=q_chunk,
                     remat=remat)
    logits = torch.matmul(x, params["embed"].T)
    loss = sharded_cross_entropy(logits, batch["labels"])
    return loss, {"nll": loss}


def prefill(params: Dict, batch: Dict, cfg: ArchConfig, *,
            q_chunk: Optional[int] = None):
    enc_out = encode(params, batch["frames"], cfg)
    x = decode_train(params, batch["tokens"], enc_out, cfg, q_chunk=q_chunk,
                     remat=False)
    return torch.matmul(x[:, -1], params["embed"].T), {}


# -- decode ------------------------------------------------------------------


def encoder_cache_spec(cfg: ArchConfig, B: int) -> Dict:
    """Cross-attention K/V per decoder layer, precomputed from enc output."""
    Hkv, D = cfg.n_kv_heads, cfg.hd
    F = cfg.encoder.n_frames
    return {str(i): {"xk": CacheSpec((B, F, Hkv, D), torch.bfloat16),
                     "xv": CacheSpec((B, F, Hkv, D), torch.bfloat16)}
            for i in range(cfg.n_layers)}


def build_cross_cache(params: Dict, enc_out: torch.Tensor,
                      cfg: ArchConfig) -> Dict:
    B, F, _ = enc_out.shape
    Hkv, D = cfg.n_kv_heads, cfg.hd
    out = {}
    for i in range(cfg.n_layers):
        p = params["layers"][str(i)]["xattn"]
        out[str(i)] = {
            "xk": dense(enc_out, p["wk"]).reshape(B, F, Hkv, D),
            "xv": dense(enc_out, p["wv"], p["bv"]).reshape(B, F, Hkv, D),
        }
    return out


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """One decoder token over the self-K/V ring (written in place) and
    the fixed cross-K/V.  tokens: (B, 1) -> (logits (B, V), cache)."""
    B = tokens.shape[0]
    pos = cache["pos"]
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = _embed(params, tokens)
    # sinusoidal position at `pos`, on the device
    pe = _sin_cos(pos.float() * _inv_timescales(cfg.d_model, x.device))
    x = x + pe[None, None].to(x.dtype)
    new_layers: Dict[str, Dict] = {}
    for i in range(cfg.n_layers):
        p = params["layers"][str(i)]
        lc = cache["layers"][str(i)]
        h = _ln(x, p["norm1"])
        a = p["attn"]
        q = dense(h, a["wq"], a["bq"]).reshape(B, 1, Hq, D)
        k = dense(h, a["wk"]).reshape(B, 1, Hkv, D)
        v = dense(h, a["wv"], a["bv"]).reshape(B, 1, Hkv, D)
        o = ring_attend(q, k, v, lc, pos)
        x = x + dense(o.reshape(B, 1, Hq * D), a["wo"], a["bo"])
        # cross attention over the fixed encoder K/V
        h = _ln(x, p["normx"])
        xa = p["xattn"]
        qx = dense(h, xa["wq"], xa["bq"]).reshape(B, 1, Hq, D)
        xc = cache["cross"][str(i)]
        F = xc["xk"].shape[1]
        lengths = torch.full((B,), F, dtype=torch.int32, device=x.device)
        ox = decode_attention(qx, xc["xk"], xc["xv"], lengths)
        x = x + dense(ox.reshape(B, 1, Hq * D), xa["wo"], xa["bo"])
        x = x + _mlp(p["ffn"], _ln(x, p["norm2"]))
        new_layers[str(i)] = dict(lc)
    x = _ln(x, params["final_norm"])
    logits = torch.matmul(x[:, 0], params["embed"].T)
    return logits, step_cache(cache, new_layers, pos + 1)
