"""Share of its roofline that the digest-and-compare reaches: the least
time of the digest passes recorded in the traced window (every byte of
the saved state read once, per chunk a previous digest read and a
digest and a flag written, against HBM bandwidth, or the digest's
integer instructions against their peak, whichever is larger; from the
state's shapes and `chunk_bytes` alone) over the device time of the
digest kernels named here."""
from chipbench.harness.readers import kernel_roofline_pct

#: the digest kernels of `src/repro_torch/csrc/fingerprint.cu`
KERNELS = ("leaves_cmp_kernel", "digest_kernel")


def read(rec):
    return kernel_roofline_pct(rec, KERNELS)
