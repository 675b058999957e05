"""qwen2-vl-2b [arXiv:2409.12191]: 28L d_model=1536 12H (GQA kv=2)
d_ff=8960 vocab=151936 — M-RoPE, dynamic-resolution vision stub."""
from .base import ArchConfig, VLMSpec

CONFIG = ArchConfig(
    arch_id="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, head_dim=128,
    norm="rms", mlp="swiglu", qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6, source="arXiv:2409.12191",
    vlm=VLMSpec(n_patches=256, grid=(16, 16), mrope_sections=(16, 24, 24)),
)
