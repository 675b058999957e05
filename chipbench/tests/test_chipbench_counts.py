"""The yardstick: the digest spec, the work counted from shapes alone,
the reduction of a device trace."""
import numpy as np
import pytest
import torch

from chipbench.harness import trace
from chipbench.reference import counts, digest, peaks
from chipbench.reference.model import Shape

QWEN = Shape(L=24, E=1024, Hq=16, Hkv=16, D=64, F=2816, V=151936,
             theta=1e6, eps=1e-6, tied=True, qkv_bias=True)
GRANITE = Shape(L=32, E=1536, Hq=24, Hkv=8, D=64, F=512, V=49155,
                theta=1e4, eps=1e-6, tied=True, qkv_bias=False, experts=40,
                top_k=8)


@pytest.mark.parametrize("shape,dtype,chunk", [
    ((1000,), np.float32, 256), ((37, 3), np.uint16, 64), ((), np.int32, 64),
    ((5, 7), np.uint8, 8), ((4096,), np.uint16, 2048), ((3, 5), np.uint16, 6)])
def test_digest_spec_matches_the_ports_plain_digest(shape, dtype, chunk):
    from repro_torch.kernels.ops import leaf_fingerprint_np
    a = np.random.default_rng(1).integers(0, 2**16, size=shape).astype(dtype)
    want = leaf_fingerprint_np(a, chunk_bytes=chunk)
    raw = np.frombuffer(a.tobytes(), np.uint8)
    got = digest.chunk_digests(raw, a.dtype.itemsize, chunk,
                               range(want.shape[0]))
    assert digest.n_chunks_of(raw.size, a.dtype.itemsize, chunk) == \
        want.shape[0]
    for ci in range(want.shape[0]):
        assert got[ci] == want[ci].astype("<u4").tobytes()
        step = digest.chunk_step(raw.size, a.dtype.itemsize, chunk)
        assert digest.digest_bytes(raw[ci * step:(ci + 1) * step]) == got[ci]


def test_digest_work_counts_bytes_and_instructions_from_shapes():
    # a 1 MiB leaf in 256 KiB chunks and a 6-byte one
    nbytes, ops = counts.digest_work([(1 << 20, 2), (6, 2)], 1 << 18)
    assert nbytes == (1 << 20) + 6 + (4 + 1) * (16 + 16 + 4)
    words = (1 << 20) // 4 + 2
    assert ops == words * 4 + (1 << 18) // 4 * 4 * 9
    bound = counts.digest_bound_s(nbytes, ops)
    assert bound == pytest.approx(nbytes / peaks.HBM_BYTES_PER_S)
    assert bound > ops / peaks.INT32_OPS_PER_S


def test_digest_work_of_the_training_state():
    # 4.64 GB, the same count whatever digests it
    from chipbench.reference.model import param_shapes
    leaves = []
    for _path, shape, dtype, _init in param_shapes(QWEN):
        n = int(np.prod(shape))
        item = torch.tensor([], dtype=dtype).element_size()
        leaves += [(n * item, item), (n * 4, 4), (n * 4, 4)]
    nbytes, ops = counts.digest_work(leaves, 1 << 18)
    assert len(leaves) == 870
    assert 4.63e9 < nbytes < 4.66e9
    assert counts.digest_bound_s(nbytes, ops) == pytest.approx(
        nbytes / 3.35e12)


def test_train_flops_count_the_backward_only_down_to_the_trained_layers():
    s = Shape(L=4, E=8, Hq=2, Hkv=1, D=4, F=16, V=32, theta=1e4, eps=1e-6,
              tied=True, qkv_bias=False)
    B, S = 2, 3
    tokens, pairs = B * S, B * S * (S + 1) // 2
    qkv = 2 * 8 * (2 + 2) * 4
    layer = qkv + 2 * 2 * 4 * 8 + 3 * 2 * 8 * 16
    attn = 2 * 2 * 2 * 4 * pairs
    head = 2 * 8 * 32 * tokens
    fwd = 4 * (layer * tokens + attn) + head
    # only the top layer and the final norm: the head's input gradient,
    # that layer's input gradients but its q, k, v inputs', and its
    # weights' gradients
    top = head + 2 * attn + layer * tokens - qkv * tokens + layer * tokens
    assert counts.train_step_flops(s, B, S, [3], False, True) == fwd + top
    assert counts.train_step_flops(s, B, S, [], False, False) == fwd
    every = counts.train_step_flops(s, B, S, [0, 1, 2, 3], True, True)
    assert every == fwd + 2 * head + 4 * (2 * attn + 2 * layer * tokens) \
        - qkv * tokens
    # Qwen1.5-0.5B's top two layers at 8 x 128 tokens: ~1.4 TFLOP
    assert 1.3e12 < counts.train_step_flops(QWEN, 8, 128, [22, 23], False,
                                            True) < 1.5e12


def test_decode_flops_count_each_tokens_top_k_experts():
    per_token = GRANITE.L * (2 * 1536 * (24 + 16) * 64 + 2 * 24 * 64 * 1536
                             + 2 * 1536 * 40 + 8 * 3 * 2 * 1536 * 512) \
        + 2 * 1536 * 49155
    attn = GRANITE.L * 2 * 2 * 24 * 64 * (10 + 11)
    assert counts.decode_step_flops(GRANITE, 2, [9, 10]) == \
        2 * per_token + attn


class Ev:
    def __init__(self, name, start, dur, dev, annotation=False):
        self._n, self._s, self._d, self._dev = name, start, dur, dev
        self._a = annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def is_user_annotation(self):
        return self._a


def test_trace_reduction_unions_device_intervals_inside_the_marks():
    evs = [Ev("chipbench.active", 100, 1000, False),
           Ev("chipbench.decode", 100, 400, False),
           Ev("chipbench.save_session", 500, 600, False),
           Ev("gemm", 50, 100, True),           # clipped to [100, 150]
           Ev("gemm", 120, 100, True),          # overlaps: union to 220
           Ev("leaves_cmp_kernel", 700, 50, True),
           Ev("chipbench.decode", 100, 400, True, annotation=True),
           Ev("late", 2000, 10, True)]          # outside the marks
    r = trace.reduce_events(evs)
    assert r["window_s"] == pytest.approx(1000e-9)
    assert r["busy_s"] == pytest.approx((120 + 50) * 1e-9)
    assert r["ops"]["gemm"] == {"count": 2, "s": pytest.approx(150e-9)}
    assert "late" not in r["ops"] and "chipbench.decode" not in r["ops"]
    # gaps [220, 700] while the host decoded, [750, 1100] while it saved
    assert r["idle_gaps"] == [["decode", pytest.approx(480e-9)],
                              ["save_session", pytest.approx(350e-9)]]
    assert trace.reduce_events([Ev("gemm", 0, 5, True)]) is None


def test_store_comparison_is_bit_exact():
    from chipbench.harness import checks
    a = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    want = {"p": {"w": a, "z": torch.zeros((), dtype=torch.int32)},
            "step": 3, "data/seed": 7}
    got = {"p": {"w": a.clone(), "z": torch.zeros((), dtype=torch.int32)},
           "step": 3, "data": {"seed": 7}}
    assert checks.tree_mismatches(got, want) == 0
    flipped = a.clone()
    flipped.view(torch.int16)[1, 2] ^= 1              # one bit of one leaf
    assert checks.tree_mismatches(dict(got, p={"w": flipped,
                                               "z": got["p"]["z"]}),
                                  want) == 1
    assert checks.tree_mismatches(dict(got, step=4), want) == 1
    assert checks.tree_mismatches({"p": got["p"]}, want) == 2
    assert not checks.same(a, a.float())              # other dtype
