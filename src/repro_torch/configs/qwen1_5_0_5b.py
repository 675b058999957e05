"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B]: 24L d_model=1024 16H (GQA kv=16)
d_ff=2816 vocab=151936, QKV bias, tied embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab=151936, head_dim=64,
    norm="rms", mlp="swiglu", qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6, source="hf:Qwen/Qwen1.5-0.5B",
)
