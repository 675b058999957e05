"""kimi-k2-1t-a32b [arXiv:2501.kimi2, paper-table]: 61L d_model=7168 64H
(GQA kv=8) vocab=163840, MoE 384 experts top-8 (+1 shared), expert d_ff=2048,
first layer dense d_ff=18432.  Trillion-parameter total / ~32B active."""
from .base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    arch_id="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, head_dim=112,
    norm="rms", mlp="swiglu", tie_embeddings=False,
    rope_theta=5e4, source="arXiv:2501.kimi2",
    first_dense_layers=1, first_dense_ff=18432,
    moe=MoESpec(n_experts=384, top_k=8, expert_ff=2048, n_shared=1,
                capacity_factor=1.25),
)
