"""Architecture + shape configuration system.

One `ArchConfig` per assigned architecture (see configs/<id>.py), plus the
four assigned input-shape cells.  Every config is selectable by id via
``--arch`` in the launchers; `reduced()` yields the family-preserving small
config used by CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    expert_ff: int
    n_shared: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    expand: int = 2
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 256
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class RGLRUSpec:
    lru_width: int = 0          # 0 → d_model
    d_conv: int = 4
    attn_window: int = 2048
    pattern: int = 3            # every `pattern`-th block is local attention


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    n_layers: int = 6
    n_frames: int = 1500        # stub frontend sequence length


@dataclasses.dataclass(frozen=True)
class VLMSpec:
    n_patches: int = 256        # stub patch embeddings per sample
    grid: Tuple[int, int] = (16, 16)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 → d_model // n_heads
    norm: str = "rms"           # rms | ln
    mlp: str = "swiglu"         # swiglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    first_dense_layers: int = 0      # MoE models: leading dense layers
    first_dense_ff: int = 0
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    rglru: Optional[RGLRUSpec] = None
    encoder: Optional[EncoderSpec] = None
    vlm: Optional[VLMSpec] = None
    source: str = ""
    # execution knobs (shared defaults; overridden per shape/mesh)
    q_chunk: int = 1024
    remat: bool = True
    # §Perf hillclimb toggles (baseline values are the paper-faithful run)
    ep_axis: str = "model"      # "data" = EP over data axis (no per-
    #                             microbatch expert-weight regather)
    mixed_attn: bool = False    # bf16 QK operands (f32 accum) → bf16
    #                             dK/dV all-reduces (half the wire bytes)
    seq_sp: bool = False        # sequence-parallel residual stream:
    #                             tokens' S stays sharded over `model`
    #                             between blocks (kills the per-layer f32
    #                             activation all-gathers of the baseline)

    # family constants, not fields (so `dataclasses.asdict` of every
    # config the reference package shares stays the reference's)
    rope: ClassVar[bool] = True            # rotary embedding in attention
    embed_scale: ClassVar[bool] = True     # input embedding x sqrt(d_model)
    ssm_inner_norms: ClassVar[bool] = False    # RMSNorms on Mamba's dt, B, C
    router_renormalize: ClassVar[bool] = True  # top-k weights sum to one

    def held_experts(self) -> Optional[Tuple[int, int]]:
        """(first, count) of the experts this device holds of each MoE
        layer, which routes over all ``moe.n_experts``; None: all."""
        return None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_plan(self) -> List[Tuple[str, str]]:
        """Per-layer (mixer, ffn) plan."""
        plan: List[Tuple[str, str]] = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                plan.append(("mamba", "none"))
            elif self.family == "hybrid":
                assert self.rglru is not None
                pat = self.rglru.pattern
                mixer = "attn_local" if (i % pat == pat - 1) else "rglru"
                plan.append((mixer, self.mlp))
            elif self.family == "moe":
                assert self.moe is not None
                ffn = "dense_first" if i < self.first_dense_layers else "moe"
                plan.append(("attn", ffn))
            else:  # dense / vlm / encdec decoder
                plan.append(("attn", self.mlp))
        return plan

    def reduced(self) -> "ArchConfig":
        """Family-preserving small config for CPU smoke tests."""
        small: Dict = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=256,
            vocab=512,
            head_dim=32,
        )
        if self.moe is not None:
            small["moe"] = MoESpec(n_experts=min(self.moe.n_experts, 8),
                                   top_k=min(self.moe.top_k, 2),
                                   expert_ff=64,
                                   n_shared=min(self.moe.n_shared, 1))
            small["first_dense_layers"] = min(self.first_dense_layers, 1)
            small["first_dense_ff"] = 256 if self.first_dense_layers else 0
        if self.ssm is not None:
            small["ssm"] = SSMSpec(expand=2, d_state=4, d_conv=4, dt_rank=8,
                                   chunk=8)
        if self.rglru is not None:
            small["rglru"] = RGLRUSpec(lru_width=128, d_conv=4,
                                       attn_window=16,
                                       pattern=self.rglru.pattern)
            small["n_layers"] = 3
        if self.encoder is not None:
            small["encoder"] = EncoderSpec(n_layers=1, n_frames=16)
        if self.vlm is not None:
            small["vlm"] = VLMSpec(n_patches=16, grid=(4, 4),
                                   mrope_sections=(4, 6, 6))
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class JambaConfig(ArchConfig):
    """Jamba's hybrid decoder [arXiv:2403.19887; HF `JambaConfig`]: layer
    i mixes by attention where ``i % attn_period == attn_offset`` and by
    Mamba-1 elsewhere; its FFN is routed experts where ``i %
    expert_period == expert_offset`` and one SwiGLU elsewhere.  Attention
    has no positional encoding, the input embedding is not scaled, Mamba
    normalises dt, B and C, and the router's top-k softmax weights are
    not renormalised.  Under expert parallelism a device holds experts
    ``experts_held = (first, count)`` of each MoE layer: the router keeps
    every expert, and the layer adds only its own experts' part."""
    attn_period: int = 8
    attn_offset: int = 4
    expert_period: int = 2
    expert_offset: int = 1
    experts_held: Optional[Tuple[int, int]] = None   # None: every expert

    rope: ClassVar[bool] = False
    embed_scale: ClassVar[bool] = False
    ssm_inner_norms: ClassVar[bool] = True
    router_renormalize: ClassVar[bool] = False

    def held_experts(self) -> Optional[Tuple[int, int]]:
        return self.experts_held

    def layer_plan(self) -> List[Tuple[str, str]]:
        return [("attn" if i % self.attn_period == self.attn_offset
                 else "mamba",
                 "moe" if i % self.expert_period == self.expert_offset
                 else self.mlp)
                for i in range(self.n_layers)]

    def reduced(self) -> "JambaConfig":
        """One whole period of layers, GQA, 8 routed experts of which 4
        are held, the Mamba inner norms: every kind of layer at a tiny
        width."""
        return dataclasses.replace(
            ArchConfig.reduced(self), n_layers=self.attn_period,
            n_kv_heads=2, experts_held=(0, 4),
            moe=MoESpec(n_experts=8, top_k=2, expert_ff=64))


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                   # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

#: archs allowed to run long_500k (sub-quadratic attention; see DESIGN.md)
LONG_CONTEXT_OK = {
    "falcon-mamba-7b", "recurrentgemma-9b", "starcoder2-3b", "starcoder2-7b",
}


def applicable_shapes(cfg: ArchConfig) -> List[str]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.arch_id in LONG_CONTEXT_OK:
        names.append("long_500k")
    return names
