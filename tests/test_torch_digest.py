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


def _segments(W, head, n_seg, seg_vecs):
    """Word ranges each segment of one K2 row digests, as
    `csrc/fingerprint.cu` cuts the row: `head` scalar words up to the
    first 16-byte boundary, then 16-byte vectors, of which segment s owns
    [s * seg_vecs, (s + 1) * seg_vecs); segment 0 also owns the head and
    the scalar tail after the last whole vector."""
    head = min(head, W)
    nvec = (W - head) // 4
    tail = head + 4 * nvec
    segs = []
    for s in range(n_seg):
        lo, hi = min(s * seg_vecs, nvec), min((s + 1) * seg_vecs, nvec)
        segs.append([(head + 4 * lo, head + 4 * hi)]
                    + ([(0, head), (tail, W)] if s == 0 else []))
    return segs


PLANS = [(1, 1), (1, 3), (2, 5), (3, 4099), (1, 9000), (1, 9001), (2, 9002),
         (3, 9003), (64, 128), (1, 1 << 20), (3, 1 << 20), (149, 1 << 20),
         (512, 1 << 20), (70000, 128), (1 << 22, 1 << 20), (1 << 22, 1),
         (1 << 22, 4099)]


@pytest.mark.parametrize("C,W", PLANS)
def test_digest_plan_segments_tile_each_row(C, W):
    R, n_seg, seg_vecs = tfp.digest_plan(C, W)
    assert R in (1, 2, 4, 8) and R <= max(C, 1)
    assert R == 1 or W % 4 == 0          # rows of a block share alignment
    assert n_seg * seg_vecs >= W // 4    # the launcher's coverage check
    groups = -(-C // R)
    grid = groups * n_seg
    assert grid <= max(groups, 2 * tfp.DIGEST_TARGET_BLOCKS) < 2**31
    for head in range(4):                # the row's words before 16 bytes
        count = np.zeros(W, np.int64)
        for seg in _segments(W, head, n_seg, seg_vecs):
            for lo, hi in seg:
                count[lo:hi] += 1
        assert (count == 1).all()        # segments tile [0, W) exactly


# (C, W, head, cuts): cuts None takes the segments of digest_plan(C, W)
# for a row whose first `head` words precede a 16-byte boundary; otherwise
# the segments are [cuts[k], cuts[k + 1]).  W % 4 in {0, 1, 2, 3}, unequal
# segments, and boundaries off 16-byte boundaries.
SPLITS = [(1, 9000, 0, None), (1, 9001, 1, None), (2, 9002, 2, None),
          (3, 9003, 3, None), (2, 9000, 3, None), (2, 13, 0, [0, 5, 6, 13]),
          (3, 4099, 0, [0, 1, 1000, 4098, 4099]),
          (1, 4098, 0, [0, 2047, 2048, 4098]),
          (4, 4096, 0, [0, 3, 1027, 4096])]


@pytest.mark.parametrize("C,W,head,cuts", SPLITS)
def test_split_partials_sum_to_digest(C, W, head, cuts):
    """Partial sums over any split of [0, W), each mod 2^32, plus the
    length folds give the digest: the arithmetic K2's split-W relies on."""
    words, lens = _case(C, W, C * 7 + W)
    if cuts is None:
        segs = _segments(W, head, *tfp.digest_plan(C, W)[1:])
        assert len(segs) > 1
    else:
        segs = [[(a, b)] for a, b in zip(cuts, cuts[1:])]
    weights = tref.lane_weights(W, 11, "cpu").numpy().astype(np.uint32)
    total = np.zeros((C, 4), np.uint32)
    with np.errstate(over="ignore"):
        for seg in segs:
            part = np.zeros((C, 4), np.uint32)
            for lo, hi in seg:
                for d in range(4):
                    part[:, d] += (words[:, lo:hi] * weights[d, lo:hi]).sum(
                        axis=1, dtype=np.uint32)
            total += part
        total += tref.length_folds(_t(lens), 11).numpy().astype(np.uint32)
    assert (total == u32(tref.fingerprint_words_ref(_t(words), _t(lens),
                                                    seed=11))).all()
    assert (total == np.asarray(rfp.fingerprint_words(
        jnp.asarray(words), jnp.asarray(lens), seed=11,
        interpret=True))).all()


@pytest.mark.parametrize("dt,n", [("uint8", 9), ("int8", 13), ("bool", 9),
                                  ("bfloat16", 7), ("float16", 6)])
def test_to_words_of_views_off_word_boundaries(dt, n):
    """A 1-byte or 2-byte slice t[1:] starts off a 4-byte boundary: its
    words are a copy, equal to the reference's."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) * 50
    if dt == "bool":
        x = np.asarray(x > 0)
    elif dt == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    else:
        x = x.astype(dt)
    view = np_to_torch(x)[1:]
    assert view.storage_offset() * view.element_size() % 4
    want = rops.to_words_np(x[1:])
    assert (u32(tops.to_words(view)) == want).all()
    words, _ = tops.leaf_words(view, chunk_bytes=8)
    assert (u32(words).reshape(-1)[:want.size] == want).all()


@pytest.mark.parametrize("C,W,offset,fill", [
    (1, 1 << 20, 1, None), (3, 4096, 2, None), (5, 1 << 16, 3, None),
    (9, 4099, 3, None), (2, 7, 1, None), (1, 2, 1, None),
    (3, 1 << 20, 0, 0xFFFFFFFF), (4, 4099, 2, 0xFFFFFFFF)])
def test_digest_kernel_on_views_and_all_ones_on_card(cuda, C, W, offset,
                                                      fill):
    """K2 bit-exact on rows that start `offset` words past a 16-byte
    boundary (views of a larger tensor: data_ptr() % 16 == 4 * offset)
    and on all-0xFFFFFFFF words and lengths."""
    rng = np.random.default_rng(C * W + offset)
    flat = rng.integers(0, 2**32, size=C * W + 4, dtype=np.uint32)
    lens = rng.integers(1, W * 4 + 1, size=(C,)).astype(np.uint32)
    if fill is not None:
        flat[:] = fill
        lens[:] = fill
    big = _t(flat).to(cuda)
    assert big.data_ptr() % 16 == 0
    w = big[offset:offset + C * W].view(C, W)
    assert w.data_ptr() % 16 == 4 * offset
    ln = _t(lens).to(cuda)
    got = tfp.fingerprint_words(w, ln, seed=0xFFFFFFFF)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.fingerprint_words_ref(w, ln,
                                                       seed=0xFFFFFFFF))
    assert (u32(got.cpu()) == rref.fingerprint_words_np(
        flat[offset:offset + C * W].reshape(C, W), lens,
        seed=0xFFFFFFFF)).all()


@pytest.mark.parametrize("C,W", SWEEP + [
    (64, 128), (64, 1 << 20), (1, 3), (2, 5), (3, 4099), (1, 1 << 20),
    (3, 1 << 20), (149, 1 << 20), (70000, 128)])
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


def test_build_library_compiles_once_across_threads(monkeypatch, tmp_path):
    """Async save bodies on several threads may make the first launch at
    once: one compile, and every caller gets the library (before, each
    thread compiled into one temporary file and all but the first rename
    failed)."""
    import subprocess
    import time
    from concurrent.futures import ThreadPoolExecutor
    calls = []

    def fake_nvcc(cmd, **kw):
        calls.append(cmd)
        time.sleep(0.2)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"library")
        return subprocess.CompletedProcess(cmd, 0, "ptxas report", "")

    monkeypatch.setattr(tfp, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(tfp.subprocess, "run", fake_nvcc)
    with ThreadPoolExecutor(8) as ex:
        out = list(ex.map(lambda _: tfp.build_library(), range(8)))
    assert len(calls) == 1
    assert len({lib for lib, _ in out}) == 1
    assert out[0][0].read_bytes() == b"library"
    assert sorted(report for _, report in out) == [""] * 7 + ["ptxas report"]
