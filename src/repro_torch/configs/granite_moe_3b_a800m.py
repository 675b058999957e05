"""granite-moe-3b-a800m [hf:ibm-granite]: 32L d_model=1536 24H (GQA kv=8)
vocab=49155, MoE 40 experts top-8, expert d_ff=512."""
from .base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    arch_id="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155, head_dim=64,
    norm="rms", mlp="swiglu", tie_embeddings=True,
    rope_theta=1e4, source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    moe=MoESpec(n_experts=40, top_k=8, expert_ff=512, n_shared=0,
                capacity_factor=1.25),
)
