"""AI21-Jamba2-Mini [hf:ai21labs/AI21-Jamba2-Mini]: 32L d_model=4096,
attention (32H, GQA kv=8, head 128, no positional encoding) in layers
4, 12, 20, 28 and Mamba-1 (d_state 16, d_conv 4, expand 2, dt_rank 256)
in the other 28; 16 SwiGLU experts of width 14336, top-2, in the odd
layers and one SwiGLU of that width in the even; vocab 65536, untied
head.  The published model is 52B-A12B; this device holds experts 0-7
of each MoE layer, as one of two devices that share every MoE layer by
expert parallelism."""
from .base import JambaConfig, MoESpec, SSMSpec

CONFIG = JambaConfig(
    arch_id="ai21-jamba2-mini", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, head_dim=128,
    norm="rms", mlp="swiglu", tie_embeddings=False,
    source="hf:ai21labs/AI21-Jamba2-Mini",
    moe=MoESpec(n_experts=16, top_k=2, expert_ff=14336, n_shared=0,
                capacity_factor=1.25),
    ssm=SSMSpec(expand=2, d_state=16, d_conv=4, dt_rank=256, chunk=64),
    attn_period=8, attn_offset=4, expert_period=2, expert_offset=1,
    experts_held=(0, 8),
)
