"""falcon-mamba-7b [arXiv:2410.05355]: 64L d_model=4096 attention-free
mamba-1, vocab 65024, ssm_state=16."""
from .base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    arch_id="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=65024,
    norm="rms", tie_embeddings=False, source="arXiv:2410.05355",
    ssm=SSMSpec(expand=2, d_state=16, d_conv=4, dt_rank=256, chunk=64),
)
