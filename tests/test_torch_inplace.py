"""K1 reading the leaves in place, vs the reference's packed path.

The port's fused path digests every chunk where it lies in its leaf,
through a row table per plan (`kernels.batch._plan_rows`), where the
reference packs the leaves into bucket matrices first.  Here the same
numpy leaves go through the reference's `digest_leaves_fused` (Pallas in
interpret mode) and the port's (the kernel's plain version on the CPU):
digests, dirty column, speculated payload and the one counted fetch
must match bit for bit.  Leaves cover what a row table must get right:
byte counts that end mid-word, scalars, empty leaves, non-contiguous
tensors and views off 4- and 16-byte boundaries, leaves of many chunks
with a partial tail, and snapshot views whose gap bytes are 0xFF.  The
work decomposition that the CUDA kernel runs is checked word by word on
the host (`inplace_plan`); the kernel itself against its plain version on
a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import batch as rbatch
from repro_torch.kernels import batch as tbatch
from repro_torch.kernels import fingerprint as tfp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def np_to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy (bfloat16 via its uint16 bits) -> CPU tensor, same bytes."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bf16(x) -> np.ndarray:
    return np.asarray(jnp.asarray(np.asarray(x, np.float32), jnp.bfloat16))


def _after(first, a: np.ndarray) -> torch.Tensor:
    """A view t[k:] of a fresh tensor whose elements from k on are `a`
    (`first` holds the k elements before it)."""
    return np_to_torch(np.concatenate([first, a]))[len(first):]


def _transposed(a: np.ndarray) -> torch.Tensor:
    """A non-contiguous tensor with the values of 2-D `a`."""
    return np_to_torch(np.ascontiguousarray(a.T)).T


def _case(name: str, rng):
    """(numpy leaves, port tensors with the same values) of one case."""
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    i8 = lambda n: rng.integers(-100, 100, n).astype(np.int8)  # noqa: E731
    if name == "odd_bytes":
        leaves = {"bf_odd": _bf16(rng.standard_normal(7)),
                  "i8_1": i8(1), "i8_2": i8(2), "i8_3": i8(3),
                  "b_1": rng.random(1) > 0.5, "b_3": rng.random(3) > 0.5,
                  "f16_5": rng.standard_normal(5).astype(np.float16)}
        return leaves, {k: np_to_torch(v) for k, v in leaves.items()}
    if name == "scalars":
        leaves = {"s1": np.asarray(np.int8(-7)), "s4": np.asarray(
            np.float32(2.5)), "s8": np.asarray(np.float64(-1.25)),
            "b0": np.asarray(True), "empty": np.zeros((0, 3), np.float32),
            "i64": rng.integers(-2**40, 2**40, 5)}
        return leaves, {k: np_to_torch(v) for k, v in leaves.items()}
    if name == "views":
        leaves = {"t_f32": f32(37, 5), "t_bf": _bf16(rng.standard_normal(
            (9, 11))), "s_bf1": _bf16(rng.standard_normal(301)),
            "s_i8": i8(203), "s_bool": rng.random(77) > 0.5,
            "s_f32": f32(130), "s_bf2": _bf16(rng.standard_normal(90))}
        port = {"t_f32": _transposed(leaves["t_f32"]),
                "t_bf": _transposed(leaves["t_bf"]),
                # t[1:] of 1- and 2-byte dtypes: off a 4-byte boundary
                "s_bf1": _after(_bf16([1.0]), leaves["s_bf1"]),
                "s_i8": _after(i8(1), leaves["s_i8"]),
                "s_bool": _after(np.asarray([True]), leaves["s_bool"]),
                # read in place 4 bytes past a 16-byte boundary
                "s_f32": _after(f32(1), leaves["s_f32"]),
                "s_bf2": _after(_bf16([1.0, 2.0]), leaves["s_bf2"])}
        return leaves, port
    if name == "multi_chunk":
        leaves = {"f32": f32(1000), "bf": _bf16(rng.standard_normal(777)),
                  "i8": i8(1001), "m": f32(40, 33),
                  "b": rng.random(999) > 0.3}
        return leaves, {k: np_to_torch(v) for k, v in leaves.items()}
    if name == "snapshot":
        leaves = {"bf": _bf16(rng.standard_normal(333)), "i8": i8(45),
                  "f32": f32(17, 3), "b": rng.random(6) > 0.5,
                  "s": np.asarray(np.int8(3))}
        views, buf = tops.snapshot_tensors(
            [np_to_torch(v) for v in leaves.values()])
        # the gaps between the leaves' bytes hold 0xFF: never to be read
        used = torch.zeros(buf.numel(), dtype=torch.bool)
        for v in views:
            o = v.data_ptr() - buf.data_ptr()
            used[o:o + v.numel() * v.element_size()] = True
        assert not used.all()
        buf[~used] = 0xFF
        return leaves, dict(zip(leaves, views))
    raise ValueError(name)


CASES = ["odd_bytes", "scalars", "views", "multi_chunk", "snapshot"]


def _items(leaves, port):
    return ([(k, jnp.asarray(v)) for k, v in leaves.items()],
            list(port.items()))


def _spec_keys(rng, keys, plan):
    """Every leaf's last (tail) chunk, the last real row of every bucket
    (the row before its padding), and a random half of the rest."""
    by_leaf = {}
    for k in keys:
        by_leaf[k.rpartition("#[")[0]] = k
    spec = set(by_leaf.values())
    off = 0
    for b in plan.buckets:
        off += b.n_rows
        spec.add(keys[off - 1])
    return spec | {k for k in keys if rng.random() < 0.5}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("chunk", [64, 256])
def test_inplace_fused_matches_reference(case, chunk, monkeypatch):
    rng = np.random.default_rng(CASES.index(case) * 7 + chunk)
    leaves, port = _case(case, rng)
    with jax.enable_x64(True):      # 8-byte leaves stay 8-byte
        jl, tl = _items(leaves, port)
        keys = rbatch.digest_leaves(jl, chunk_bytes=chunk).keys
        plan = tbatch.plan_leaves(tbatch._specs(tl), chunk)
        spec = _spec_keys(rng, keys, plan)
        base = {k: rng.integers(0, 2**32, 4, dtype=np.uint32).tobytes()
                for k in keys if rng.random() < 0.7}
        want, rtable = rbatch.digest_leaves_fused(
            jl, chunk_bytes=chunk, lookup=base.get, spec_keys=spec)
        fetches = tops.fetch_count
        got, ttable = tbatch.digest_leaves_fused(
            tl, chunk_bytes=chunk, lookup=base.get, spec_keys=spec)
        assert tops.fetch_count == fetches + 1 and got.n_syncs == 1
        assert got.keys == want.keys and got.leaf_rows == want.leaf_rows
        assert (got.mat == want.mat).all()
        assert (got.dirty == want.dirty).all()
        assert got.payload == want.payload and set(got.payload) == spec
        assert [t.numpy().view(np.uint32).tolist() for t in ttable.digs] == \
            [np.asarray(d).tolist() for d in rtable.digs]
        assert all(d.data_ptr() >= ttable.flat.data_ptr() for d in ttable.digs)

        # the steady state: the device table is the first call's flat
        # output, used as it is (no re-seed); every row is clean now
        want2, _ = rbatch.digest_leaves_fused(jl, chunk_bytes=chunk,
                                              table=rtable, spec_keys=spec)
    monkeypatch.setattr(tbatch, "seed_device_table",
                        lambda *a: pytest.fail("re-seeded"))
    got2, ttable2 = tbatch.digest_leaves_fused(
        tl, chunk_bytes=chunk, table=ttable, spec_keys=spec)
    assert tops.fetch_count == fetches + 2 and got2.n_syncs == 1
    assert (got2.dirty == want2.dirty).all() and not got2.dirty.any()
    assert got2.payload == want2.payload
    assert torch.equal(ttable2.flat, ttable.flat)


@pytest.mark.parametrize("case", CASES)
def test_plan_rows_read_the_reference_packed_rows(case):
    """Each slot row read through the row table is the reference's packed
    row up to its word count, and the packed row holds zeros after it;
    padded rows hold no words and fold length 0."""
    rng = np.random.default_rng(CASES.index(case))
    leaves, port = _case(case, rng)
    with jax.enable_x64(True):
        jl, tl = _items(leaves, port)
        plan = tbatch.plan_leaves(tbatch._specs(tl), 64)
        packed = [np.asarray(m) for m in
                  rbatch._packer_for(rbatch.plan_leaves(plan_specs(jl), 64))(
                      *[a for _, a in jl])]
    rows = tbatch._plan_rows(plan)
    want_len = np.concatenate(rbatch._plan_lengths(rbatch.plan_leaves(
        plan_specs(jl), 64)))
    assert (rows.lengths == want_len).all()
    assert (rows.nfull * 4 + rows.part == rows.lengths).all()
    flats = [tfp.readable_leaf(t).reshape(-1).view(torch.uint8)
             for _, t in tl]
    mat = np.concatenate(packed)
    for c in range(rows.n_rows):
        w = tref._row_words(flats[rows.leaf[c]], int(rows.word_off[c]),
                            int(rows.nfull[c]), int(rows.part[c]))
        n = int(rows.nwords[c])
        assert (w.numpy().view(np.uint32) == mat[c, :n]).all()
        assert not mat[c, n:].any()
    off = 0
    for b in plan.buckets:
        assert not rows.nwords[off + b.n_rows:off + b.padded_rows].any()
        off += b.padded_rows


def plan_specs(items):
    return tuple((k, tuple(a.shape), str(a.dtype)) for k, a in items)


# ---------------------------------------------------------------------------
# the CUDA kernel's work decomposition, word by word on the host
# ---------------------------------------------------------------------------

def _tables():
    """(name, RowTable, leaf word offsets past 16 bytes) the planner must
    cut exactly: plans of short and long rows and packed matrices whose
    rows start at every offset."""
    out = []
    for name, shapes, chunk in (
            ("short", [(1000,), (77,), (3,), (0,), ()], 256),
            ("long", [(40000,), (70000,), (5000,), (9,)], 1 << 16),
            ("mixed", [(300000,), (17,), (4100,), (2049,)], 1 << 15)):
        specs = tuple((f"l{i}", s, "float32") for i, s in enumerate(shapes))
        plan = tbatch.plan_leaves(specs, chunk)
        for mis in ([0] * len(shapes), [1, 3, 2, 0, 1][:len(shapes)]):
            out.append((name, tbatch._plan_rows(plan), np.asarray(mis)))
    for C, W, mis in ((3, 4099, 3), (70, 128, 0), (2, 9000, 1),
                      (5, 2048, 2), (1, 1 << 20, 1), (9, 7, 1)):
        out.append((f"matrix{C}x{W}", tfp.matrix_table(C, W),
                    np.asarray([mis])))
    return out


TABLES = _tables()


@pytest.mark.parametrize("name,table,mis", TABLES,
                         ids=[f"{n}-{m.tolist()}" for n, _, m in TABLES])
def test_inplace_plan_covers_every_word_once(name, table, mis):
    """Simulate the kernel's items: every row lands in one group of equal
    whole words and head, and its head, body segments, tail and partial
    word cover [0, nwords) exactly once."""
    grows, items, n_arrivals, smem = tfp.inplace_plan(table,
                                                     mis.astype(np.int64)
                                                     .tobytes())
    assert sorted(grows.tolist()) == list(range(table.n_rows))
    heads = tfp.row_heads(table, mis)
    count = [np.zeros(int(n), np.int64) for n in table.nwords]
    counters = set()
    seen_fold = np.zeros(table.n_rows, np.int64)
    for start, n, seg, n_seg, seg_vecs, counter, tl, _ in items.tolist():
        rows = grows[start:start + n]
        nfull, head = int(table.nfull[rows[0]]), int(heads[rows[0]])
        assert (table.nfull[rows] == nfull).all() and \
            (heads[rows] == head).all()
        nvec = (nfull - head) // 4
        tail = head + 4 * nvec
        if seg < 0:
            assert n <= tfp.SHORT_ROWS and nfull <= tfp.SHORT_WORDS
            assert tl % 4 == 0 and tl >= 4 + nfull + 1 - head
            assert smem >= tl * 16
            seen_fold[rows] += 1
            for r in rows:    # a warp per row: body vectors, then scalars
                count[r][head:tail] += 1
                n_sc = head + (nfull - tail) + int(table.part[r] > 0)
                assert n_sc <= 32
                for lane in range(n_sc):
                    p = lane if lane < head else tail + (lane - head)
                    assert 0 <= p + 4 - head < tl   # its weight's entry
                    count[r][p] += 1
            assert nvec == 0 or 4 + 4 * (nvec - 1) + 3 < tl
            continue
        assert n <= tfp.LONG_ROWS and nfull > tfp.SHORT_WORDS
        assert n_seg * seg_vecs >= nvec and seg_vecs % tfp.LONG_STEP == 0
        if n_seg > 1:
            assert 0 <= counter < n_arrivals
            counters.add((counter, start))
        lo, hi = min(seg * seg_vecs, nvec), min((seg + 1) * seg_vecs, nvec)
        for r in rows:
            spans = [(head + 4 * lo, head + 4 * hi)]
            if seg == 0:                       # head, tail, partial word
                spans += [(0, head), (tail, int(table.nwords[r]))]
            for a, b in spans:
                count[r][a:b] += 1
        if seg == 0:
            seen_fold[rows] += 1
    assert all((c == 1).all() for c in count)
    assert (seen_fold == 1).all()
    assert len({c for c, _ in counters}) == n_arrivals


@pytest.mark.parametrize("mis", [[0, 0, 0], [1, 2, 3]])
def test_payload_slots_align_rows_and_do_not_overlap(mis):
    specs = (("a", (1001,), "int8"), ("b", (333,), "float32"),
             ("c", (7,), "bfloat16"))
    plan = tbatch.plan_leaves(specs, 256)
    rows = tbatch._plan_rows(plan)
    mis = np.asarray(mis)
    pick = np.arange(0, rows.n_rows, 2)
    slots = tfp.payload_slots(rows, mis, pick)
    heads = tfp.row_heads(rows, mis)
    assert ((slots[pick].astype(np.int64) + heads[pick]) % 4 == 0).all()
    spans = sorted((int(slots[r]), int(slots[r]) + int(rows.nwords[r]))
                   for r in pick)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert (slots[np.setdiff1d(np.arange(rows.n_rows), pick)]
            == tfp.NO_SLOT).all()


@pytest.mark.parametrize("C,W,offset", [(3, 4099, 1), (4, 128, 0),
                                        (2, 9, 3), (5, 2050, 2)])
def test_matrix_table_reads_the_packed_rows(C, W, offset):
    """The packed API's table (one leaf of C rows of W words, rows of any
    alignment) read by the plain in-place version is the packed digest."""
    rng = np.random.default_rng(C * W + offset)
    big = torch.from_numpy(rng.integers(0, 2**32, C * W + offset,
                                        dtype=np.uint32).view(np.int32))
    words = big[offset:].view(C, W)
    lens = torch.from_numpy(rng.integers(0, 4 * W + 1, C).astype(np.int32))
    prev = tref.fingerprint_words_ref(words, lens, seed=3)
    prev[::2, 1] ^= 5
    m = tfp.matrix_table(C, W)
    table = tfp.RowTable(leaf=m.leaf, word_off=m.word_off, nfull=m.nfull,
                         part=m.part, lengths=lens.numpy().view(np.uint32))
    d, dirty, payload = tfp.fingerprint_leaves_cmp([words], table, prev,
                                                   seed=3)
    pd, pm = tref.fingerprint_words_cmp_ref(words, lens, prev, seed=3)
    assert torch.equal(d, pd) and torch.equal(dirty, pm)
    assert payload.numel() == 0


# ---------------------------------------------------------------------------
# on a card: the kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode (its plain "
                    "version is tested here)")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("chunk", [64, 1 << 14])
def test_inplace_kernel_matches_plain_on_card(cuda, case, chunk):
    rng = np.random.default_rng(CASES.index(case) + chunk)
    leaves, port = _case(case, rng)
    dev = [t.to(cuda) if t.is_contiguous() else t.T.contiguous().to(cuda).T
           for t in port.values()]
    plan = tbatch.plan_leaves(tbatch._specs(list(zip(port, dev))), chunk)
    rows = tbatch._plan_rows(plan)
    readable = [tfp.readable_leaf(t) for t in dev]
    spec = np.arange(0, rows.n_rows, 3)
    slots = tfp.payload_slots(rows, tfp.leaf_mis(readable), spec)
    prev = torch.from_numpy(rng.integers(0, 2**32, (rows.n_rows, 4),
                                         dtype=np.uint32).view(np.int32))
    prev = prev.to(cuda)
    got = tfp.fingerprint_leaves_cmp(dev, rows, prev, slots, seed=9)
    want = tref.fingerprint_leaves_cmp_ref(readable, rows, prev, slots,
                                           seed=9)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for r in spec:
        a, n = int(slots[r]), int(rows.nwords[r])
        assert torch.equal(got[2][a:a + n], want[2][a:a + n])


def test_launch_refuses_rows_past_a_leaf(monkeypatch):
    """The launcher checks the table against the leaves' sizes before it
    hands the kernel any pointer (the check runs on the host)."""
    rows = tbatch._plan_rows(tbatch.plan_leaves(
        (("a", (100,), "float32"),), 64))
    prev = torch.zeros((rows.n_rows, 4), dtype=torch.int32)
    monkeypatch.setattr(tfp, "_library", lambda: pytest.fail("launched"))
    with pytest.raises(ValueError, match="past the end"):
        tfp._launch_cmp(rows, [torch.zeros(99)], prev, None, seed=0)
