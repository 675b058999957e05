"""recurrentgemma-9b [arXiv:2402.19427]: 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000 — RG-LRU + local attention, pattern 2 recurrent :
1 local-attn, window 2048."""
from .base import ArchConfig, RGLRUSpec

CONFIG = ArchConfig(
    arch_id="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    norm="rms", mlp="swiglu", tie_embeddings=True,
    rope_theta=1e4, source="arXiv:2402.19427",
    rglru=RGLRUSpec(lru_width=4096, d_conv=4, attn_window=2048, pattern=3),
)
