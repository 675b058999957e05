"""Unified decoder stack of the dense / moe / ssm / hybrid / vlm families:
the port of `repro.models.transformer` (whisper's enc-dec lives in
`whisper.py` and reuses these pieces).  Forward passes apply the
reference's divisibility-aware sharding constraints
(`parallel/sharding.constrain`, identities without an active mesh):
batch over (pod, data); attention scores sequence-parallel over `model`;
decode KV-cache time over `model`; experts / fused head / ffn dims over
`model`.

Each layer is (mixer, ffn) from `cfg.layer_plan()`:
    mixer ∈ {attn, attn_local, mamba, rglru}
    ffn   ∈ {swiglu, gelu, moe, dense_first, none}

Parameters are declared once in `param_defs` (shape + dtype + logical
axes + init) and live in a nested dict of tensors whose paths are the
reference's, so a Chipmink save of either package's state names the same
leaves.

Serving: `decode_step` writes each new token's K and V into the cache
tensors in place (`index_copy_` at slot ``pos % T``), and copies each
recurrent layer's new conv window and SSM / LRU state into the cache's
own tensors (`copy_`); ``pos``, the slot and the valid lengths stay on
the device, so a step makes no host sync.  The returned cache holds the
same state tensors and a new ``pos``, its keys in the order the
reference's jitted step returns them (`step_cache`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..parallel.sharding import (constrain, einsum, from_local, is_dtensor,
                                 reshape, shard_offset)
from .attention import attention, decode_attention
from .layers import (ParamDef, ParamDefs, TensorSpec, apply_mrope,
                     apply_rope, dense, embedding, gelu_mlp, gelu_tanh,
                     layer_norm, matmul, rms_norm, round_to, sigmoid,
                     swiglu)
from .moe import MoEConfig, moe_ffn
from .rglru import lru_coeffs
from .ssm import (SSMConfig, causal_conv1d, conv_step, linear_scan,
                  mamba_block, mamba_decode_step)

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
    E = cfg.d_model
    if kind in ("swiglu", "dense_first"):
        F = cfg.first_dense_ff if kind == "dense_first" else cfg.d_ff
        return {
            p + ("w_gate",): ParamDef((E, F), None, ("embed", "ffn")),
            p + ("w_up",): ParamDef((E, F), None, ("embed", "ffn")),
            p + ("w_down",): ParamDef((F, E), None, ("ffn", "embed")),
        }
    if kind == "gelu":
        F = cfg.d_ff
        return {
            p + ("w_up",): ParamDef((E, F), None, ("embed", "ffn")),
            p + ("b_up",): ParamDef((F,), None, ("ffn",), "zeros"),
            p + ("w_down",): ParamDef((F, E), None, ("ffn", "embed")),
            p + ("b_down",): ParamDef((E,), None, (None,), "zeros"),
        }
    if kind == "moe":
        m = cfg.moe
        X, F = m.n_experts, m.expert_ff
        held = cfg.held_experts()
        Xh = held[1] if held else X       # experts of this device
        if cfg.ep_axis == "data":
            ax_in = ("experts_dp", None, "ffn")
            ax_out = ("experts_dp", "ffn", None)
        else:
            ax_in = ("experts", "embed", None)
            ax_out = ("experts", None, "embed")
        defs: ParamDefs = {
            p + ("router",): ParamDef((E, X), torch.float32,
                                      ("embed", None)),
            p + ("w_gate",): ParamDef((Xh, E, F), None, ax_in),
            p + ("w_up",): ParamDef((Xh, E, F), None, ax_in),
            p + ("w_down",): ParamDef((Xh, F, E), None, ax_out),
        }
        if m.n_shared:
            Fs = F * m.n_shared
            defs[p + ("shared_gate",)] = ParamDef((E, Fs), None,
                                                  ("embed", "ffn"))
            defs[p + ("shared_up",)] = ParamDef((E, Fs), None,
                                                ("embed", "ffn"))
            defs[p + ("shared_down",)] = ParamDef((Fs, E), None,
                                                  ("ffn", "embed"))
        return defs
    if kind == "none":
        return {}
    raise ValueError(kind)


def _mamba_defs(p: Tuple[str, ...], cfg: ArchConfig) -> ParamDefs:
    s = cfg.ssm
    E = cfg.d_model
    Ei = s.expand * E
    K, N, R = s.d_conv, s.d_state, s.dt_rank
    f32 = torch.float32
    defs: ParamDefs = {}
    if cfg.ssm_inner_norms:
        # Jamba's RMSNorms of dt, B and C, stored as offsets from 1
        defs = {p + ("dt_norm",): ParamDef((R,), f32, (None,), "zeros"),
                p + ("b_norm",): ParamDef((N,), f32, (None,), "zeros"),
                p + ("c_norm",): ParamDef((N,), f32, (None,), "zeros")}
    return {
        **defs,
        p + ("in_proj",): ParamDef((E, 2 * Ei), None, ("embed", "inner")),
        p + ("conv_w",): ParamDef((K, Ei), None, (None, "inner")),
        p + ("conv_b",): ParamDef((Ei,), None, ("inner",), "zeros"),
        p + ("x_proj",): ParamDef((Ei, R + 2 * N), None, ("inner", None)),
        p + ("dt_proj",): ParamDef((R, Ei), None, (None, "inner")),
        p + ("dt_bias",): ParamDef((Ei,), f32, ("inner",), "zeros"),
        p + ("A_log",): ParamDef((Ei, N), f32, ("inner", None), "ones"),
        p + ("D",): ParamDef((Ei,), f32, ("inner",), "ones"),
        p + ("out_proj",): ParamDef((Ei, E), None, ("inner", "embed")),
    }


def _rglru_defs(p: Tuple[str, ...], cfg: ArchConfig) -> ParamDefs:
    r = cfg.rglru
    E = cfg.d_model
    W = r.lru_width or E
    H = 16 if W % 16 == 0 else 1          # block-diagonal gate blocks
    K = r.d_conv
    return {
        p + ("in_gate",): ParamDef((E, W), None, ("embed", "lru_heads")),
        p + ("in_rec",): ParamDef((E, W), None, ("embed", "lru_heads")),
        p + ("conv_w",): ParamDef((K, W), None, (None, "lru_heads")),
        p + ("conv_b",): ParamDef((W,), None, ("lru_heads",), "zeros"),
        p + ("gate_a",): ParamDef((H, W // H, W // H), None,
                                  ("lru_heads", None, None)),
        p + ("gate_x",): ParamDef((H, W // H, W // H), None,
                                  ("lru_heads", None, None)),
        p + ("lambda",): ParamDef((W,), torch.float32, ("lru_heads",),
                                  "ones"),
        p + ("out_proj",): ParamDef((W, E), None, ("lru_heads", "embed")),
    }


def param_defs(cfg: ArchConfig) -> ParamDefs:
    E, V = cfg.d_model, cfg.vocab
    defs: ParamDefs = {
        ("embed",): ParamDef((V, E), None, ("vocab", "embed"), "embed"),
    }
    if not cfg.tie_embeddings:
        defs[("lm_head",)] = ParamDef((E, V), None, ("embed", "vocab"))
    defs.update(_norm_defs(("final_norm",), cfg))
    if cfg.vlm is not None:
        defs[("patch_proj",)] = ParamDef((E, E), None, ("embed", None))
    for i, (mixer, ffn) in enumerate(cfg.layer_plan()):
        p = ("layers", str(i))
        defs.update(_norm_defs(p + ("norm1",), cfg))
        if mixer in ("attn", "attn_local"):
            defs.update(_attn_defs(p + ("attn",), cfg))
        elif mixer == "mamba":
            defs.update(_mamba_defs(p + ("mamba",), cfg))
        elif mixer == "rglru":
            defs.update(_rglru_defs(p + ("rec",), cfg))
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


def _ssm_cfg(cfg: ArchConfig) -> SSMConfig:
    s = cfg.ssm
    return SSMConfig(d_inner=s.expand * cfg.d_model, d_state=s.d_state,
                     d_conv=s.d_conv, dt_rank=s.dt_rank, chunk=s.chunk,
                     inner_norms=cfg.ssm_inner_norms)


def _moe_cfg(cfg: ArchConfig, n_tokens: int) -> MoEConfig:
    m = cfg.moe
    return MoEConfig(n_experts=m.n_experts, top_k=m.top_k,
                     expert_ff=m.expert_ff, n_shared=m.n_shared,
                     capacity_factor=m.capacity_factor,
                     n_groups=math.gcd(n_tokens, 1024),
                     ep_logical="experts_dp" if cfg.ep_axis == "data"
                     else "experts")


def _ffn(params: Dict, x: torch.Tensor, cfg: ArchConfig,
         ffn: str) -> Tuple[torch.Tensor, Dict]:
    """The layer's FFN -> (output, aux): the MoE's aux loss and expert
    counts, else {}."""
    if ffn in ("swiglu", "dense_first"):
        return swiglu(x, params["w_gate"], params["w_up"],
                      params["w_down"]), {}
    if ffn == "gelu":
        return gelu_mlp(x, params["w_up"], params["b_up"], params["w_down"],
                        params["b_down"]), {}
    B, S, _ = x.shape
    y, aux_loss, counts = moe_ffn(x, params, _moe_cfg(cfg, B * S),
                                  held=cfg.held_experts(),
                                  renormalize=cfg.router_renormalize)
    return y, {"moe_aux": aux_loss, "expert_counts": counts}


def _qkv(params: Dict, x: torch.Tensor, cfg: ArchConfig):
    B, S, _ = x.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = reshape(dense(x, params["wq"], params.get("bq")), B, S, Hq, D)
    k = reshape(dense(x, params["wk"], params.get("bk")), B, S, Hkv, D)
    v = reshape(dense(x, params["wv"], params.get("bv")), B, S, Hkv, D)
    return q, k, v


def _rotate(q: torch.Tensor, k: torch.Tensor, cfg: ArchConfig,
            positions: torch.Tensor, mrope_positions: Optional[torch.Tensor]):
    if mrope_positions is not None:
        sections = cfg.vlm.mrope_sections
        return (apply_mrope(q, mrope_positions, sections, cfg.rope_theta),
                apply_mrope(k, mrope_positions, sections, cfg.rope_theta))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _attn_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                positions: torch.Tensor, window: Optional[int],
                q_chunk: Optional[int],
                mrope_positions: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    if cfg.rope:
        q, k = _rotate(q, k, cfg, positions, mrope_positions)
    # sequence-parallel attention: queries' S over `model`, kv replicated
    q = constrain(q, ("batch", "seq_model", None, None))
    k = constrain(k, ("batch", None, None, None))
    v = constrain(v, ("batch", None, None, None))
    o = attention(q, k, v, causal=True, window=window, q_chunk=q_chunk,
                  mixed=cfg.mixed_attn)
    o = constrain(o, ("batch", "seq_model", None, None))
    return dense(reshape(o, B, S, cfg.n_heads * cfg.hd), params["wo"])


def _layer_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig, mixer: str,
                 ffn: str, *, positions: torch.Tensor,
                 q_chunk: Optional[int],
                 mrope_positions: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    h = _norm(x, params["norm1"], cfg)
    if mixer in ("attn", "attn_local"):
        h = _attn_apply(params["attn"], h, cfg, positions=positions,
                        window=_window(cfg, mixer), q_chunk=q_chunk,
                        mrope_positions=mrope_positions)
    elif mixer == "mamba":
        h = mamba_block(params["mamba"], h, _ssm_cfg(cfg))
    elif mixer == "rglru":
        h = _recurrent_apply(params["rec"], h, cfg)
    x = x + h
    aux: Dict = {}
    if ffn != "none":
        h, aux = _ffn(params["ffn"], _norm(x, params["norm2"], cfg), cfg,
                      ffn)
        x = x + h
    x = constrain(x, ("batch", "seq_model" if cfg.seq_sp else None, None))
    return x, aux


# -- Griffin's recurrent block with block-diagonal RG-LRU gates -------------

def _apply_block_gate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, L, W); w: (H, W/H, W/H) block-diagonal gate."""
    B, L, W = x.shape
    H = w.shape[0]
    y = einsum("blhi,hij->blhj", reshape(x, B, L, H, W // H), w)
    return reshape(y, B, L, W)


def _lru_gates(params: Dict, x: torch.Tensor):
    r = sigmoid(_apply_block_gate(x, params["gate_a"]).float())
    i = sigmoid(_apply_block_gate(x, params["gate_x"]).float())
    return lru_coeffs(r, i, params["lambda"], x)


def _rg_lru_blockdiag(params: Dict, x: torch.Tensor) -> torch.Tensor:
    a, b = _lru_gates(params, x)
    _, h = linear_scan(a, b, dim=1)
    return h.to(x.dtype)


def _rg_lru_blockdiag_step(params: Dict, x: torch.Tensor,
                           state: torch.Tensor):
    """x: (B, 1, W), state (B, W) -> (y (B,1,W), new_state)."""
    a, b = _lru_gates(params, x)
    new = a[:, 0] * state + b[:, 0]
    return new[:, None].to(x.dtype), new


def _recurrent_apply(params: Dict, x: torch.Tensor,
                     cfg: ArchConfig) -> torch.Tensor:
    gate = gelu_tanh(dense(x, params["in_gate"]))
    rec = dense(x, params["in_rec"])
    rec = causal_conv1d(rec, params["conv_w"], params["conv_b"])
    rec = _rg_lru_blockdiag(params, rec)
    return dense(rec * gate, params["out_proj"])


def _decode_recurrent(params: Dict, x: torch.Tensor, lcache: Dict,
                      cfg: ArchConfig):
    """-> (output, new conv window, new LRU state); the cache is not
    written here."""
    gate = gelu_tanh(dense(x, params["in_gate"]))
    rec = dense(x, params["in_rec"])                     # (B,1,W)
    window = torch.cat([lcache["conv"], rec], dim=1)     # (B,K,W)
    rec = conv_step(window, params["conv_w"], params["conv_b"])
    rec = rec[:, None].to(x.dtype)
    y, new_lru = _rg_lru_blockdiag_step(params, rec, lcache["lru"])
    out = dense(y * gate, params["out_proj"])
    return out, window[:, 1:], new_lru


# ---------------------------------------------------------------------------
# embeddings / logits / positions
# ---------------------------------------------------------------------------


def embed_tokens(params: Dict, tokens: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """Rows of the embedding, in bf16, times sqrt(d_model) rounded to bf16
    (the reference multiplies two bf16 values) where the family scales
    them."""
    x = embedding(tokens, params["embed"]).to(torch.bfloat16)
    if not cfg.embed_scale:
        return x
    return x * round_to(math.sqrt(cfg.d_model), torch.bfloat16)


def logits_from(params: Dict, x: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return matmul(x, head)


def mrope_positions_for(cfg: ArchConfig, B: int, S: int, *,
                        device: Any = None) -> torch.Tensor:
    """(3, B, S) t/h/w position streams: patch grid first, then text."""
    v = cfg.vlm
    P = min(v.n_patches, S)
    gh, gw = v.grid
    idx = torch.arange(S, device=device)
    patch_h = (idx // gw) % gh
    patch_w = idx % gw
    text = torch.clamp(idx - P, min=0) + (gh + gw)
    is_text = idx >= P
    zero = torch.zeros_like(idx)
    pos = torch.stack([torch.where(is_text, text, zero),
                       torch.where(is_text, text, patch_h),
                       torch.where(is_text, text, patch_w)])   # (3, S)
    return pos[:, None, :].expand(3, B, S)


# ---------------------------------------------------------------------------
# top level: forward / loss / prefill / decode
# ---------------------------------------------------------------------------


def forward(params: Dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            patch_embeds: Optional[torch.Tensor] = None,
            q_chunk: Optional[int] = None,
            remat: bool = False) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward -> (hidden (B, S, E) after the final norm,
    aux: per-layer lists of the MoE layers' ``moe_aux`` and
    ``expert_counts``).  ``remat`` checkpoints each layer: its
    activations are recomputed in the backward pass instead of kept."""
    B, S = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    mrope_pos = None
    if cfg.vlm is not None:
        if patch_embeds is None:
            raise ValueError(f"{cfg.arch_id} needs patch_embeds")
        P = patch_embeds.shape[1]
        patches = dense(patch_embeds.to(torch.bfloat16),
                        params["patch_proj"])
        x = torch.cat([patches, x[:, P:]], dim=1)
        mrope_pos = mrope_positions_for(cfg, B, S, device=tokens.device)
    x = constrain(x, ("batch", "seq_model" if cfg.seq_sp else None, None))
    positions = torch.arange(S, device=tokens.device)
    aux_all: Dict[str, List] = {}
    for i, (mixer, ffn) in enumerate(cfg.layer_plan()):
        lp = params["layers"][str(i)]
        kw = dict(positions=positions, q_chunk=q_chunk,
                  mrope_positions=mrope_pos)
        if remat:
            x, aux = checkpoint(_layer_apply, lp, x, cfg, mixer, ffn,
                                use_reentrant=False, **kw)
        else:
            x, aux = _layer_apply(lp, x, cfg, mixer, ffn, **kw)
        for k, v in aux.items():
            aux_all.setdefault(k, []).append(v)
    return _norm(x, params["final_norm"], cfg), aux_all


def sharded_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean of logsumexp minus the label's logit, in float32.  The
    reference picks the label's logit with a one-hot einsum (which never
    gathers a model-sharded vocab); on one device a gather gives the same
    float32 value.  On a DTensor the vocab stays sharded: the logsumexp
    is taken from each shard's max and sum of exponentials, and each rank
    picks the labels its shard holds (`_label_logits`)."""
    lf = logits.float()
    if is_dtensor(lf):
        from torch.distributed.tensor import Replicate
        m = torch.amax(lf, dim=-1, keepdim=True).detach()
        s = torch.sum(torch.exp(lf - m), dim=-1)
        # the shards' partial sums, summed here: left to the log, DTensor
        # would gather the whole (B, S, V) gradient in the backward pass
        s = s.redistribute(s.device_mesh, [
            Replicate() if p.is_partial() else p for p in s.placements])
        lse = torch.log(s) + m[..., 0]
    else:
        lse = torch.logsumexp(lf, dim=-1)                         # (B, S)
    return torch.mean(lse - _label_logits(lf, labels))


def _label_logits(lf: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``lf[..., labels]``, (B, S).  For a DTensor `lf`, vocab-parallel:
    every rank reads the labels that fall in its vocab shard (zero for
    the rest), and the shards' picks sum over the vocab's mesh dims (a
    `Partial` placement there)."""
    if not is_dtensor(lf):
        return torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, places, last = lf.device_mesh, lf.placements, lf.ndim - 1
    lead = [p if isinstance(p, Shard) and p.dim < last else Replicate()
            for p in places]
    lab = labels.redistribute(mesh, lead).to_local().long()
    local = lf.to_local()
    rel = lab - shard_offset(lf, last)
    owned = (rel >= 0) & (rel < local.shape[-1])
    idx = torch.clamp(rel, 0, local.shape[-1] - 1)
    picked = torch.where(owned, torch.gather(local, -1, idx[..., None])[..., 0],
                         torch.zeros((), dtype=local.dtype,
                                     device=local.device))
    out = [Partial() if p == Shard(last) else q
           for p, q in zip(places, lead)]
    return from_local(picked, mesh, out, labels.shape)


def loss_fn(params: Dict, batch: Dict, cfg: ArchConfig, *,
            q_chunk: Optional[int] = None,
            remat: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy (+ 1e-2 x the mean MoE aux loss).  batch:
    tokens, labels (B, S) int [, patch_embeds].  Returns (loss,
    {"nll"[, "moe_aux", "expert_counts" (n_moe_layers, X)]})."""
    x, aux = forward(params, batch["tokens"], cfg,
                     patch_embeds=batch.get("patch_embeds"),
                     q_chunk=q_chunk, remat=remat)
    logits = constrain(logits_from(params, x, cfg), ("batch", None, "vocab"))
    loss = sharded_cross_entropy(logits, batch["labels"])
    metrics = {"nll": loss}
    if "moe_aux" in aux:
        moe_loss = 1e-2 * torch.mean(torch.stack(aux["moe_aux"]))
        loss = loss + moe_loss
        metrics["moe_aux"] = moe_loss
        metrics["expert_counts"] = torch.stack(aux["expert_counts"])
    return loss, metrics


def prefill(params: Dict, batch: Dict, cfg: ArchConfig, *,
            q_chunk: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Process a full prompt -> (last-position logits (B, V), {}).  As in
    the reference, the serve loop fills caches decode-first."""
    x, _ = forward(params, batch["tokens"], cfg,
                   patch_embeds=batch.get("patch_embeds"), q_chunk=q_chunk)
    return logits_from(params, x[:, -1], cfg), {}


#: a cache leaf's abstract tensor
CacheSpec = TensorSpec


def cache_spec(cfg: ArchConfig, B: int, T: int) -> Dict:
    """Cache tree of `CacheSpec` leaves.  Windowed attention caches are
    ring buffers of min(T, window); SSM and LRU layers keep their conv
    window (bf16) and state (float32); an encoder's cross K/V rides
    under ``cross``."""
    layers: Dict[str, Dict] = {}
    Hkv, D = cfg.n_kv_heads, cfg.hd
    bf16, f32 = torch.bfloat16, torch.float32
    for i, (mixer, _ffn) in enumerate(cfg.layer_plan()):
        if mixer in ("attn", "attn_local"):
            window = _window(cfg, mixer)
            Tw = T if window is None else min(T, window)
            layers[str(i)] = {"k": CacheSpec((B, Tw, Hkv, D), bf16),
                              "v": CacheSpec((B, Tw, Hkv, D), bf16)}
        elif mixer == "mamba":
            s = cfg.ssm
            Ei = s.expand * cfg.d_model
            layers[str(i)] = {
                "conv": CacheSpec((B, s.d_conv - 1, Ei), bf16),
                "ssm": CacheSpec((B, Ei, s.d_state), f32)}
        elif mixer == "rglru":
            W = cfg.rglru.lru_width or cfg.d_model
            layers[str(i)] = {
                "conv": CacheSpec((B, cfg.rglru.d_conv - 1, W), bf16),
                "lru": CacheSpec((B, W), f32)}
    spec = {"layers": layers, "pos": CacheSpec((), torch.int32)}
    if cfg.encoder is not None:
        from .whisper import encoder_cache_spec
        spec["cross"] = encoder_cache_spec(cfg, B)
    return spec


def cache_axes(cfg: ArchConfig) -> Dict:
    """Logical-axes tree matching cache_spec (decode sharding: cache time
    over `model`, state inner dims over `model`)."""
    layers: Dict[str, Dict] = {}
    for i, (mixer, _ffn) in enumerate(cfg.layer_plan()):
        if mixer in ("attn", "attn_local"):
            layers[str(i)] = {"k": ("batch", "cache_t", None, None),
                              "v": ("batch", "cache_t", None, None)}
        elif mixer == "mamba":
            layers[str(i)] = {"conv": ("batch", None, "inner"),
                              "ssm": ("batch", "inner", None)}
        elif mixer == "rglru":
            layers[str(i)] = {"conv": ("batch", None, "lru_heads"),
                              "lru": ("batch", "lru_heads")}
    axes = {"layers": layers, "pos": ()}
    if cfg.encoder is not None:
        from .whisper import encoder_cache_axes
        axes["cross"] = encoder_cache_axes(cfg)
    return axes


def init_cache(cfg: ArchConfig, B: int, T: int, *, device: Any) -> Dict:
    def zeros(t: Any) -> Any:
        if isinstance(t, CacheSpec):
            return torch.zeros(t.shape, dtype=t.dtype, device=device)
        return {k: zeros(v) for k, v in t.items()}

    return zeros(cache_spec(cfg, B, T))


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B, 1) -> (logits (B, V), cache).  The
    cache's state tensors are updated in place; ``pos`` is replaced.  A
    step at ``pos`` 0 begins a sequence: recurrent layers start it from a
    zero conv window and state, as attention attends to slot 0 alone, so
    a cache can serve the next sequence without being cleared."""
    pos = cache["pos"]
    x = constrain(embed_tokens(params, tokens, cfg), ("batch", None, None))
    new_layers: Dict[str, Dict] = {}
    for i, (mixer, ffn) in enumerate(cfg.layer_plan()):
        lp = params["layers"][str(i)]
        lc = cache["layers"][str(i)]
        h = _norm(x, lp["norm1"], cfg)
        if mixer in ("attn", "attn_local"):
            h = _decode_attn(lp["attn"], h, lc, pos, cfg)
        else:
            key = "ssm" if mixer == "mamba" else "lru"
            # zeros where the sequence begins (a where, not a product: a
            # state's NaN would survive a multiply by nought)
            last = {k: torch.where(pos == 0, 0.0, lc[k])
                    for k in ("conv", key)}
            if mixer == "mamba":
                h, conv, state = mamba_decode_step(
                    lp["mamba"], h, last["conv"], last["ssm"], _ssm_cfg(cfg))
            else:
                h, conv, state = _decode_recurrent(lp["rec"], h, last, cfg)
            # the new window and state are fresh tensors (not views of
            # the cache), so the copies read nothing they overwrite
            lc["conv"].copy_(conv)
            lc[key].copy_(state)
        new_layers[str(i)] = dict(lc)
        x = x + h
        if ffn != "none":
            h, _ = _ffn(lp["ffn"], _norm(x, lp["norm2"], cfg), cfg, ffn)
            x = x + h
    x = _norm(x, params["final_norm"], cfg)
    logits = logits_from(params, x[:, 0], cfg)
    return logits, step_cache(cache, new_layers, pos + 1)


def step_cache(cache: Dict, layers: Dict, pos: torch.Tensor) -> Dict:
    """The cache a step returns, its dicts' keys in sorted order, as the
    reference's jitted step returns them (jax flattens a dict by sorted
    keys: layer "10" before "2"), so a session save of either package
    walks its leaves in the same order.  ``cross`` is passed on as the
    same object."""
    out = {"layers": {k: layers[k] for k in sorted(layers)}, "pos": pos}
    if "cross" in cache:
        out = {"cross": cache["cross"], **out}
    return out


def _decode_attn(params: Dict, x: torch.Tensor, lcache: Dict,
                 pos: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg)
    if cfg.rope and cfg.vlm is not None:
        # text regime in decode: all three streams share the position
        q, k = _rotate(q, k, cfg, None, pos.expand(3, B, 1))
    elif cfg.rope:
        q, k = _rotate(q, k, cfg, pos.expand(B, 1), None)
    o = ring_attend(q, k, v, lcache, pos)
    return dense(reshape(o, B, 1, cfg.n_heads * cfg.hd), params["wo"])


def ring_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lcache: Dict, pos: torch.Tensor) -> torch.Tensor:
    """Write this token's K and V into the ring caches ``lcache["k"]`` /
    ``["v"]`` in place at slot ``pos % T`` (the reference's
    `jnp.mod(pos, T)`: a windowed cache, and a full one past T,
    overwrites its oldest slot), then attend over the valid slots."""
    k_cache, v_cache = lcache["k"], lcache["v"]
    T = k_cache.shape[1]
    slot = torch.remainder(pos, T).to(torch.int64).view(1)
    write_slot(k_cache, k, slot)
    write_slot(v_cache, v, slot)
    q = constrain(q, ("batch", None, None, None))
    k_cache = constrain(k_cache, ("batch", "cache_t", None, None))
    v_cache = constrain(v_cache, ("batch", "cache_t", None, None))
    lengths = torch.clamp(pos + 1, max=T).expand(q.shape[0])
    return decode_attention(q, k_cache, v_cache, lengths)


def write_slot(cache: torch.Tensor, x: torch.Tensor,
               slot: torch.Tensor) -> None:
    """``cache[:, slot] = x`` in place (`index_copy_` on dim 1; `slot` a
    1-element int64 tensor).  On a DTensor cache whose time dim is
    sharded, each rank writes its own shard's storage: the slot, moved
    into the shard, is written where the shard owns it and rewritten
    with its old value elsewhere (a masked write, so no host sync); `x`
    and `slot` are DTensors on the cache's mesh then."""
    if not is_dtensor(cache):
        cache.index_copy_(1, slot, x.to(cache.dtype))
        return
    from torch.distributed.tensor import Replicate, Shard
    x = x.redistribute(cache.device_mesh, [
        Replicate() if p == Shard(1) else p for p in cache.placements])
    x, slot = x.to_local(), slot.full_tensor()
    local = cache.to_local()
    rel = slot - shard_offset(cache, 1)
    idx = torch.clamp(rel, 0, local.shape[1] - 1)
    owned = ((rel >= 0) & (rel < local.shape[1])).view(1, 1, 1, 1)
    local.index_copy_(1, idx, torch.where(owned, x.to(local.dtype),
                                          local.index_select(1, idx)))
