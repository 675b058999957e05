"""qwen2.5-14b [hf:Qwen/Qwen2.5-14B]: 48L d_model=5120 40H (GQA kv=8)
d_ff=13824 vocab=152064, GQA + QKV bias."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064, head_dim=128,
    norm="rms", mlp="swiglu", qkv_bias=True, tie_embeddings=False,
    rope_theta=1e6, source="hf:Qwen/Qwen2.5-14B",
)
