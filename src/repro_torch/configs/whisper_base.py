"""whisper-base [arXiv:2212.04356]: enc-dec, 6L+6L d_model=512 8H d_ff=2048
vocab=51865; conv audio frontend is a STUB (input_specs provides frame
embeddings)."""
from .base import ArchConfig, EncoderSpec

CONFIG = ArchConfig(
    arch_id="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, head_dim=64,
    norm="ln", mlp="gelu", qkv_bias=True, tie_embeddings=True,
    source="arXiv:2212.04356",
    encoder=EncoderSpec(n_layers=6, n_frames=1500),
)
