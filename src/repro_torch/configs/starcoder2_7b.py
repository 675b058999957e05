"""starcoder2-7b [arXiv:2402.19173]: 32L d_model=4608 36H (GQA kv=4)
d_ff=18432 vocab=49152, GQA + RoPE, sliding window 4096."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49152, head_dim=128,
    norm="ln", mlp="gelu", qkv_bias=True, tie_embeddings=True,
    rope_theta=1e5, sliding_window=4096, source="arXiv:2402.19173",
)
