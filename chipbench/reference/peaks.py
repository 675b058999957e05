"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, at the
full 700 W power limit.  A card set below that limit runs slower under
load, so every reading names the card's power limit beside it.

- bf16 tensor-core rate: 989 TFLOP/s (NVIDIA's H100 data sheet).
- HBM3 bandwidth: 3.35 TB/s (same).
- 32-bit integer multiply-add, shift and logic: 64 per clock per SM on
  compute capability 9.0 (the CUDA C++ Programming Guide's throughput
  table), on 132 SMs at the 1.98 GHz boost clock.
"""
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
