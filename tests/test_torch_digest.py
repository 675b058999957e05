"""Port digest spec and word streams vs the reference package, bit-exact.

The same numpy inputs go through the reference (`repro.kernels`: its
numpy twin and the Pallas kernels in interpret mode) and
through the port (`repro_torch.kernels`: plain torch versions, the
kernel wrappers on CPU tensors, and the CUDA kernels when a card is
present).  Integer math mod 2^32: the tolerance is zero everywhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fingerprint as rfp
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import fingerprint as tfp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = ["float32", "float16", "bfloat16", "int32", "int8", "uint8",
          "bool"]
SWEEP = [(1, 1), (1, 4096), (3, 4096), (2, 5000), (7, 1), (1, 9000)]


def np_to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy (bfloat16 via its uint16 bits) -> CPU tensor, same bytes."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _case(C, W, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(C, W), dtype=np.uint32)
    lens = rng.integers(1, W * 4 + 1, size=(C,)).astype(np.uint32)
    return words, lens


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fingerprint kernels have no "
                    "CPU mode (their plain versions are tested here)")
    return torch.device("cuda")


def test_mix32_matches_reference():
    xs = np.arange(0, 2**32, 2**27, dtype=np.uint32)
    want = rref.mix32_np(xs)
    got = tref.mix32(torch.from_numpy(xs.astype(np.int64)))
    assert (got.numpy().astype(np.uint32) == want).all()
    assert (np.asarray(rref.mix32(jnp.asarray(xs))) == want).all()


@pytest.mark.parametrize("C,W", SWEEP)
def test_plain_digest_matches_reference(C, W):
    words, lens = _case(C, W, C * 31 + W)
    want = rref.fingerprint_words_np(words, lens, seed=5)
    assert (np.asarray(rfp.fingerprint_words(
        jnp.asarray(words), jnp.asarray(lens), seed=5,
        interpret=True)) == want).all()
    got = tref.fingerprint_words_ref(_t(words), _t(lens), seed=5)
    assert got.dtype == torch.int32 and tuple(got.shape) == (C, 4)
    assert (u32(got) == want).all()
    assert (tref.fingerprint_words_np(words, lens, seed=5) == want).all()


@pytest.mark.parametrize("C,W", SWEEP)
def test_plain_cmp_digest_matches_reference(C, W):
    words, lens = _case(C, W, C * 17 + W)
    dig = rref.fingerprint_words_np(words, lens, seed=3)
    prev = dig.copy()
    prev[::2, 1] ^= np.uint32(1)          # even rows dirty, odd rows clean
    rd, rm = rfp.fingerprint_words_cmp(
        jnp.asarray(words), jnp.asarray(lens), jnp.asarray(prev), seed=3,
        interpret=True, tile=min(4096, W))
    td, tm = tref.fingerprint_words_cmp_ref(_t(words), _t(lens), _t(prev),
                                            seed=3)
    assert (u32(td) == np.asarray(rd)).all()
    assert (u32(tm) == np.asarray(rm)).all()
    assert (tm.numpy() == (np.arange(C) % 2 == 0)).all()


@pytest.mark.parametrize("C,W", [(1, 1), (4, 4096), (2, 1 << 16)])
def test_all_ones_words_do_not_overflow(C, W):
    """0xFFFFFFFF words and lengths: every 32x32-bit product is maximal."""
    words = np.full((C, W), 0xFFFFFFFF, np.uint32)
    lens = np.full((C,), 0xFFFFFFFF, np.uint32)
    want = rref.fingerprint_words_np(words, lens, seed=0xFFFFFFFF)
    got = tref.fingerprint_words_ref(_t(words), _t(lens), seed=0xFFFFFFFF)
    assert (u32(got) == want).all()


def test_wrappers_take_plain_version_on_cpu():
    words, lens = _case(5, 300, 9)
    before = dict(tfp.launches)
    d = tfp.fingerprint_words(_t(words), _t(lens), seed=2)
    d2, m = tfp.fingerprint_words_cmp(_t(words), _t(lens), d, seed=2)
    assert (u32(d) == rref.fingerprint_words_np(words, lens, seed=2)).all()
    assert torch.equal(d, d2) and not m.any()
    assert tfp.launches == before          # no kernel launched on the CPU


@pytest.mark.parametrize("bad", ["dtype", "shape", "lengths", "prev",
                                 "strided"])
def test_wrappers_reject_bad_inputs(bad):
    words = torch.zeros((4, 8), dtype=torch.int32)
    lens = torch.zeros((4,), dtype=torch.int32)
    prev = torch.zeros((4, 4), dtype=torch.int32)
    if bad == "dtype":
        words = words.to(torch.int64)
    elif bad == "shape":
        words = words.reshape(-1)
    elif bad == "lengths":
        lens = lens[:3]
    elif bad == "prev":
        prev = prev[:, :3]
    else:
        words = torch.zeros((4, 16), dtype=torch.int32)[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        tfp.fingerprint_words_cmp(words, lens, prev)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", [(37, 19), ()])
def test_to_words_matches_reference(dt, shape):
    rng = np.random.default_rng(len(dt) * 7 + len(shape))
    x = rng.standard_normal(shape)
    if dt == "bool":
        x = np.asarray(x > 0)
    elif dt == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    else:
        x = np.asarray(x * 50).astype(dt)
    want = rops.to_words_np(x)
    got = tops.to_words(np_to_torch(x))
    assert got.dtype == torch.int32
    assert (u32(got) == want).all()
    assert (tops.to_words_np(x) == want).all()


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape,chunk", [((37, 19), 64), ((300, 8), 1 << 20),
                                         ((), 64), ((0, 3), 64)])
def test_leaf_fingerprint_matches_reference(dt, shape, chunk):
    rng = np.random.default_rng(len(dt) * 13 + len(shape))
    x = rng.standard_normal(shape)
    if dt == "bool":
        x = np.asarray(x > 0)
    elif dt == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    else:
        x = np.asarray(x * 50).astype(dt)
    want = rops.leaf_fingerprint_np(x, chunk_bytes=chunk, seed=3)
    fetches = tops.fetch_count
    got = tops.leaf_fingerprint(np_to_torch(x), chunk_bytes=chunk, seed=3)
    assert tops.fetch_count == fetches + 1        # one counted fetch
    assert got.shape == want.shape and (got == want).all()
    assert (tops.leaf_fingerprint_np(x, chunk_bytes=chunk, seed=3)
            == want).all()


def test_dtype_names_are_the_reference_names():
    from repro_torch.core.graph import dtype_name, itemsize_of, torch_dtype
    for dt in DTYPES + ["float64", "int64", "int16", "uint16"]:
        tdt = np_to_torch(np.zeros(1, jnp.bfloat16 if dt == "bfloat16"
                                   else dt)).dtype
        assert dtype_name(tdt) == dt
        assert torch_dtype(dt) == tdt
        assert itemsize_of(dt) == itemsize_of(tdt) == (
            2 if dt == "bfloat16" else np.dtype(dt).itemsize)


@pytest.mark.parametrize("C,W", SWEEP + [(64, 128), (64, 1 << 20)])
def test_kernels_match_plain_versions_on_card(cuda, C, W):
    words, lens = _case(C, W, C + W)
    w, ln = _t(words).to(cuda), _t(lens).to(cuda)
    plain = tref.fingerprint_words_ref(w, ln, seed=7)
    prev = plain.clone()
    prev[::2, 0] ^= 1
    got = tfp.fingerprint_words(w, ln, seed=7)
    d, m = tfp.fingerprint_words_cmp(w, ln, prev, seed=7)
    pd, pm = tref.fingerprint_words_cmp_ref(w, ln, prev, seed=7)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    assert torch.equal(d, pd) and torch.equal(m, pm)
    assert (u32(plain.cpu()) == rref.fingerprint_words_np(words, lens,
                                                          seed=7)).all()
