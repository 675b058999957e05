"""starcoder2-3b [arXiv:2402.19173]: 30L d_model=3072 24H (GQA kv=2)
d_ff=12288 vocab=49152, GQA + RoPE, sliding window 4096, LN + GELU MLP,
biases, tied embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab=49152, head_dim=128,
    norm="ln", mlp="gelu", qkv_bias=True, tie_embeddings=True,
    rope_theta=1e5, sliding_window=4096, source="arXiv:2402.19173",
)
