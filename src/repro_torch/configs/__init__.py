"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch`` ids.

`ARCHS` holds the architectures the reference package shares, one each;
`PORT_ARCHS` those of the port alone, which `get_config` also serves."""
from .ai21_jamba2_mini import CONFIG as AI21_JAMBA2_MINI
from .base import (SHAPES, ArchConfig, EncoderSpec, JambaConfig, MoESpec,
                   RGLRUSpec, SSMSpec, ShapeCell, VLMSpec, applicable_shapes,
                   LONG_CONTEXT_OK)
from .falcon_mamba_7b import CONFIG as FALCON_MAMBA_7B
from .granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B_A800M
from .kimi_k2_1t_a32b import CONFIG as KIMI_K2_1T_A32B
from .qwen1_5_0_5b import CONFIG as QWEN1_5_0_5B
from .qwen2_5_14b import CONFIG as QWEN2_5_14B
from .qwen2_vl_2b import CONFIG as QWEN2_VL_2B
from .recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B
from .starcoder2_3b import CONFIG as STARCODER2_3B
from .starcoder2_7b import CONFIG as STARCODER2_7B
from .whisper_base import CONFIG as WHISPER_BASE

ARCHS = {
    c.arch_id: c for c in [
        QWEN1_5_0_5B, QWEN2_5_14B, STARCODER2_3B, STARCODER2_7B,
        QWEN2_VL_2B, FALCON_MAMBA_7B, KIMI_K2_1T_A32B, GRANITE_MOE_3B_A800M,
        WHISPER_BASE, RECURRENTGEMMA_9B,
    ]
}


PORT_ARCHS = {c.arch_id: c for c in [AI21_JAMBA2_MINI]}


def get_config(arch_id: str) -> ArchConfig:
    cfg = ARCHS.get(arch_id) or PORT_ARCHS.get(arch_id)
    if cfg is None:
        raise KeyError(f"unknown arch {arch_id!r}; have "
                       f"{sorted(ARCHS) + sorted(PORT_ARCHS)}")
    return cfg
