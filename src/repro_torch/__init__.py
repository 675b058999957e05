"""Chipmink on PyTorch and CUDA: the port of the `repro` package.

`repro_torch` mirrors `repro`'s layout (`kernels/`, `core/`, `version/`)
and produces byte-identical manifests, pods and stores for the same
state.  It never imports JAX or the `repro` package.  The chunk
fingerprint kernels are hand-written CUDA for Hopper (`csrc/`), built
with nvcc at first use; on CPU tensors their plain PyTorch versions run.

    from repro_torch.core import Chipmink, MemoryStore
    ck = Chipmink(MemoryStore())          # device="cuda" by default
    tid = ck.save({"w": torch.randn(1024, 1024, device="cuda")})
    state = ck.load(time_id=tid)
"""
