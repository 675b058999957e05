"""Share of its roofline that the digest-and-compare of a session save
reaches: the least time of the digest passes recorded in the traced
window (the session state's bytes read once, per chunk a previous
digest read and a digest and a flag written, against HBM bandwidth, or
the integer instructions against their peak, whichever is larger; from
shapes and `chunk_bytes` alone) over the device time of the digest
kernels named here."""
from chipbench.harness.readers import kernel_roofline_pct

#: the digest kernels of `src/repro_torch/csrc/fingerprint.cu`
KERNELS = ("leaves_cmp_kernel", "digest_kernel")


def read(rec):
    return kernel_roofline_pct(rec, KERNELS)
