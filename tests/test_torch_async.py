"""Port `Chipmink(async_mode=True)` vs the reference, and its snapshot rule.

Torch tensors change in place, so the port snapshots every tensor leaf
before `save()` returns (`kernels.ops.snapshot_tensors`).  These tests
hold the podding thread behind a gate, update the saved tensors in place
right after `save()` returned, and check that the commit holds the bytes
of the call, equal to the reference's commit of the same values.
Overlapped async sequences (no `wait()` between saves, every later round
written into the same tensors) must leave a store byte-identical to the
reference's.  Copy-on-submit of numpy leaves follows the reference's
rules and warnings.  Tolerance zero.
"""
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from repro.core import Chipmink as RefChipmink
from repro.core import MemoryStore as RefMemoryStore
from repro_torch.core import Chipmink, MemoryStore
from repro_torch.core import checkpoint as port_checkpoint
from repro_torch.kernels import ops as tops

from proptest import (base_state, case_rng, mutate_state, snapshot_state,
                      sparse_mutate_state, strip_manifest, tree_equal)
from test_torch_checkpoint import (SYNC_STATS, convert, np_to_torch, to_jax,
                                   to_torch, torch_to_np)
from test_torch_version import assert_stores_equal, from_torch

#: seconds a test waits on a thread before failing instead of hanging
JOIN_S = 30.0


def write_into(live, state):
    """Bring the tensor tree `live` to the values of the numpy tree
    `state` the way a training step does: in place (``copy_``) wherever a
    tensor of that path keeps its shape and dtype, new tensors only where
    the structure changed.  Aliases of `state` stay one object."""
    memo, used = {}, set()

    def walk(old, new):
        if isinstance(new, dict):
            old = old if isinstance(old, dict) else {}
            return {k: walk(old.get(k), v) for k, v in new.items()}
        if not isinstance(new, np.ndarray):
            return new
        if id(new) in memo:
            return memo[id(new)]
        t = np_to_torch(new)
        if (isinstance(old, torch.Tensor) and id(old) not in used
                and old.shape == t.shape and old.dtype == t.dtype):
            old.copy_(t)
            t = old
        used.add(id(t))
        memo[id(new)] = t
        return t

    return walk(live, state)


class Gate:
    """Holds an instance's podding thread until `open()`: the saves
    submitted meanwhile queue behind it, so the caller can mutate state
    in place before any of their bodies has run."""

    def __init__(self, ck):
        self.event = threading.Event()
        ck.saver.submit(lambda: self.event.wait(JOIN_S))

    def open(self):
        self.event.set()


def jax_copy(state):
    """The reference's input for `state`: jax arrays of copies (aliases
    kept).  jax may wrap a numpy buffer without copying it, and a later
    in-place numpy update would then reach an in-flight reference save."""
    return to_jax(convert(state, np.copy))


def _small_state(rng):
    return to_torch(base_state(rng, rows=128))


# ---------------------------------------------------------------------------
# the snapshot rule: in-place updates after save() never reach the commit
# ---------------------------------------------------------------------------

INPLACE = {
    "add_": lambda s: s["params"]["emb"].add_(1.0),
    "copy_": lambda s: s["params"]["w"].copy_(torch.ones_like(s["params"]["w"])),
    "index_copy_": lambda s: s["opt"]["mu"].index_copy_(
        0, torch.tensor([0, 5]), torch.full((2, 16), 7.0)),
    "zero_": lambda s: s["params"]["nested"]["a"].zero_(),
}


@pytest.mark.parametrize("op", sorted(INPLACE))
def test_inplace_update_after_save_never_reaches_commit(op):
    rng = np.random.default_rng(21)
    np_state = base_state(rng, rows=128)
    state = to_torch(np_state)
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 10, device="cpu",
                  async_mode=True)
    ref = RefChipmink(RefMemoryStore(), chunk_bytes=1 << 10)
    t0 = ck.save(state)
    ck.wait()
    assert ref.save(to_jax(np_state)) == t0
    sparse_mutate_state(np_state, rng, 1)
    state = write_into(state, np_state)
    want = snapshot_state(np_state)
    gate = Gate(ck)
    t1 = ck.save(state)                      # queued behind the gate
    INPLACE[op](state)                       # before the body has run
    gate.open()
    ck.wait()
    assert tree_equal(from_torch(ck.load(time_id=t1)), want)
    # the commit is the reference's commit of the values at save() time
    assert ref.save(to_jax(np_state)) == t1
    assert strip_manifest(ck.store.get_manifest(t1)) == \
        strip_manifest(ref.store.get_manifest(t1))
    assert ck.close() == []


def test_stalled_save_snapshots_once_a_slot_frees(monkeypatch):
    """A save() that stalls on a full pipeline takes its snapshot only
    after the slot frees, so no extra copy lives through the stall."""
    state = _small_state(np.random.default_rng(23))
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 10, device="cpu",
                  async_mode=True, async_depth=1)
    gate = Gate(ck)
    seen = []
    real = port_checkpoint.snapshot_tensors

    def spy(tensors):
        seen.append(gate.event.is_set())
        return real(tensors)

    monkeypatch.setattr(port_checkpoint, "snapshot_tensors", spy)
    caller = threading.Thread(target=ck.save, args=(state,))
    caller.start()
    deadline = time.monotonic() + JOIN_S
    while ck.saver.n_stalls < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert ck.saver.n_stalls == 1 and seen == []
    gate.open()
    caller.join(JOIN_S)
    assert not caller.is_alive()
    ck.wait()
    assert seen == [True]
    assert ck.close() == []


def test_failed_prepare_releases_its_slot():
    """A submit whose prepare step raises enqueues nothing and holds no
    slot: the next submit runs at once."""
    from repro_torch.core.async_saver import AsyncSaver
    saver = AsyncSaver(depth=1)
    ran = []

    def boom():
        raise ValueError("prepare failed")

    with pytest.raises(ValueError):
        saver.submit(lambda: ran.append("dropped"), prepare=boom)
    assert not saver.busy
    saver.submit(lambda: ran.append("kept"), prepare=lambda: None)
    saver.wait()
    assert ran == ["kept"] and saver.n_stalls == 0


def test_inplace_updates_between_overlapped_saves():
    """Several saves in flight at once, each followed at once by the next
    round written in place into the same tensors: every commit loads the
    values of its own save() call."""
    rng = np.random.default_rng(22)
    np_state = base_state(rng, rows=256)
    state = to_torch(np_state)
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 10, device="cpu",
                  async_mode=True, async_depth=4)
    gate = Gate(ck)
    snaps = {}
    for r in range(3):
        snaps[ck.save(state)] = snapshot_state(np_state)
        sparse_mutate_state(np_state, rng, r + 1)
        state = write_into(state, np_state)
    gate.open()
    ck.wait()
    for tid, snap in snaps.items():
        assert tree_equal(from_torch(ck.load(time_id=tid)), snap), tid
    assert ck.close() == []


@pytest.mark.parametrize("case", range(2))
def test_overlapped_async_sequence_matches_reference(case):
    """Random rounds (values, scalars, structural edits) saved back to
    back without waiting, later rounds written in place while earlier
    bodies run: the store is byte-identical to the reference's."""
    rng = case_rng("test_overlapped_async_sequence_matches_reference", case)
    np_state = base_state(rng, rows=256)
    state = to_torch(np_state)
    kw = dict(chunk_bytes=1 << 10, async_mode=True)
    ref = RefChipmink(RefMemoryStore(), **kw)
    port = Chipmink(MemoryStore(), device="cpu", **kw)
    snaps = {}
    for r in range(6):
        if r:
            mutate_state(np_state, rng, r)
            state = write_into(state, np_state)
        tid = port.save(state)
        assert ref.save(jax_copy(np_state)) == tid
        snaps[tid] = snapshot_state(np_state)
    ref.wait()
    port.wait()
    assert_stores_equal(ref.store, port.store)
    for tid, snap in snaps.items():
        assert tree_equal(from_torch(port.load(time_id=tid)), snap), tid
    assert ref.close() == [] and port.close() == []


def test_async_warm_sparse_save_pays_one_fetch_like_reference():
    rng = np.random.default_rng(23)
    np_state = base_state(rng, rows=512)
    state = to_torch(np_state)
    kw = dict(chunk_bytes=1 << 10, async_mode=True)
    ref = RefChipmink(RefMemoryStore(), **kw)
    port = Chipmink(MemoryStore(), device="cpu", **kw)
    for r in range(5):
        if r:                      # the same rows every round: predictable
            np_state["params"]["emb"][[3, 400]] += np.float32(0.25)
            np_state["step"] = r
            state = write_into(state, np_state)
        f0 = tops.fetch_count
        port.save(state)
        port.wait()
        n_fetch = tops.fetch_count - f0
        ref.save(to_jax(np_state))
        ref.wait()
        sr, sp = ref.save_stats[-1], port.save_stats[-1]
        assert {k: sr.get(k) for k in SYNC_STATS} == \
            {k: sp.get(k) for k in SYNC_STATS}
    assert n_fetch == 1 and sp["n_digest_syncs"] == 1
    assert sp["n_gather_syncs"] == 0 and sp["n_corrective_syncs"] == 0
    assert_stores_equal(ref.store, port.store)


def test_snapshot_stats_count_every_tensor_leaf():
    rng = np.random.default_rng(24)
    state = _small_state(rng)
    state["count"] = np.arange(4, dtype=np.int64)          # host leaf
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 10, device="cpu",
                  async_mode=True)
    ck.save(state)
    ck.wait()
    st = ck.save_stats[-1]
    tensors = {id(t): t for t in (state["params"]["emb"], state["params"]["w"],
                                  state["params"]["nested"]["a"],
                                  state["opt"]["mu"])}
    want = sum(-(-t.nbytes // tops.SNAPSHOT_ALIGN) * tops.SNAPSHOT_ALIGN
               for t in tensors.values())
    assert st["n_snapshot_bytes"] == want
    assert st["t_snapshot"] >= 0.0 and st["n_leaf_copies"] == 1
    sync = Chipmink(MemoryStore(), chunk_bytes=1 << 10, device="cpu")
    sync.save(state)
    assert "n_snapshot_bytes" not in sync.save_stats[-1]


# ---------------------------------------------------------------------------
# snapshot_tensors
# ---------------------------------------------------------------------------

def _leaves():
    g = torch.Generator().manual_seed(5)
    f = torch.randn((7, 3), generator=g)
    return [
        f,
        torch.randn((5, 4), generator=g).to(torch.bfloat16),
        torch.rand((9,), generator=g) < 0.5,
        torch.tensor(3, dtype=torch.int64),
        f.t(),                                     # not contiguous
        torch.empty((0, 4)),
        torch.randint(0, 255, (13,), generator=g, dtype=torch.uint8),
        torch.randn((3, 3), generator=g, dtype=torch.float64)[1:],
    ]


def test_snapshot_tensors_copies_into_one_aligned_buffer():
    leaves = _leaves()
    before = [t.clone() for t in leaves]
    views, buf = tops.snapshot_tensors(leaves)
    assert buf.dtype == torch.uint8 and buf.dim() == 1
    base = buf.data_ptr()
    for t, v, b in zip(leaves, views, before):
        assert v.dtype == t.dtype and v.shape == t.shape
        assert v.is_contiguous()
        if v.numel():
            assert (v.data_ptr() - base) % tops.SNAPSHOT_ALIGN == 0
            assert base <= v.data_ptr() < base + buf.numel()
        assert torch.equal(v, b)
    for t in leaves:                             # the sources change ...
        if t.numel():
            t.view(-1)[0:1].fill_(1) if t.is_contiguous() else t.fill_(1)
    for v, b in zip(views, before):              # ... the snapshot not
        assert torch.equal(v, b)
    views[0].add_(1.0)                           # views are writable
    views, buf = tops.snapshot_tensors([])
    assert views == [] and buf.numel() == 0


# ---------------------------------------------------------------------------
# copy-on-submit of numpy leaves (the reference's rules and warnings)
# ---------------------------------------------------------------------------

def test_copy_on_submit_shields_small_host_leaves_like_reference():
    rng = np.random.default_rng(12)
    state = {"c": rng.standard_normal(64).astype(np.float32), "step": 0,
             "t": torch.zeros(8)}
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 12, device="cpu",
                  async_mode=True)
    want = state["c"].copy()
    gate = Gate(ck)
    t1 = ck.save(state)
    state["c"][:] += 100.0                    # mutate BEFORE the body runs
    state["t"].add_(1.0)
    gate.open()
    ck.wait()
    assert ck.save_stats[-1]["n_leaf_copies"] == 1
    got = ck.load(time_id=t1)
    assert np.array_equal(torch_to_np(got["c"]), want)
    assert torch.equal(got["t"], torch.zeros(8))


def test_copy_on_submit_threshold_and_warnings_match_reference():
    rng = np.random.default_rng(13)
    small = rng.standard_normal(16).astype(np.float32)        # 64 B
    big = rng.standard_normal((1024, 64)).astype(np.float32)  # 256 KiB
    kw = dict(chunk_bytes=1 << 12, async_mode=True,
              copy_on_submit_bytes=1 << 10)
    for ck in (RefChipmink(RefMemoryStore(), **kw),
               Chipmink(MemoryStore(), device="cpu", **kw)):
        state = {"small": small.copy(), "big": big.copy()}
        with pytest.warns(RuntimeWarning, match="copy_on_submit_bytes"):
            ck.save(state)
        ck.wait()
        state["big"][:2] += np.float32(1.0)
        with warnings.catch_warnings():
            warnings.simplefilter("error")        # same key: no re-warn
            ck.save(state)
        ck.wait()
        assert [s["n_leaf_copies"] for s in ck.save_stats] == [1, 1]
    raising = Chipmink(MemoryStore(), device="cpu", large_leaf_action="raise",
                       **kw)
    with pytest.raises(ValueError, match="copy_on_submit_bytes"):
        raising.save({"big": big})
    assert raising.store.list_time_ids() == []
    tid = raising.save({"small": small})          # still usable
    raising.wait()
    assert tid in raising.store.list_time_ids()
    for extra in (dict(large_leaf_action="ignore"),
                  dict(copy_on_submit_bytes=0)):
        quiet = Chipmink(MemoryStore(), device="cpu",
                         **dict(kw, **extra))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            quiet.save({"small": small, "big": big})
        quiet.wait()
        assert quiet.save_stats[-1]["n_leaf_copies"] == \
            (0 if extra.get("copy_on_submit_bytes") == 0 else 1)
    with pytest.raises(ValueError, match="large_leaf_action"):
        Chipmink(MemoryStore(), device="cpu", large_leaf_action="loud")


# ---------------------------------------------------------------------------
# failures: no fallback, no half-saved state
# ---------------------------------------------------------------------------

def test_snapshot_failure_raises_and_enqueues_nothing(monkeypatch):
    rng = np.random.default_rng(25)
    np_state = base_state(rng, rows=128)
    state = to_torch(np_state)
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 10, device="cpu",
                  async_mode=True)
    oracle = Chipmink(MemoryStore(), chunk_bytes=1 << 10, device="cpu",
                      incremental=False)
    assert ck.save(state) == oracle.save(state)
    ck.wait()

    def broken(tensors):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(port_checkpoint, "snapshot_tensors", broken)
    sparse_mutate_state(np_state, rng, 1)
    state = write_into(state, np_state)
    with pytest.raises(RuntimeError, match="out of memory"):
        ck.save(state)
    assert not ck.saver.busy and ck.save_stats[-1]["time_id"] == 1
    monkeypatch.undo()
    t = ck.save(state)                 # the same state as the failed call
    ck.wait()
    assert t == 3                      # the failed call used TimeID 2
    to = oracle.save(state)
    for key in ("pods", "chunks"):
        assert ck.store.get_manifest(t)[key] == \
            oracle.store.get_manifest(to)[key]
    assert tree_equal(from_torch(ck.load(time_id=t)), snapshot_state(np_state))


def test_failed_body_surfaces_and_dropped_save_does_not_corrupt_next():
    """A body that fails parks its error; the next submit re-raises it
    and drops that save after the graph cache advanced; the save after
    that must not diff against the phantom build."""
    w = torch.from_numpy(
        np.random.default_rng(9).standard_normal((64, 4)).astype(np.float32))
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 10, device="cpu",
                  async_mode=True)
    ck.save({"w": w, "step": 1})
    ck.wait()
    orig = ck.store.put_manifest
    ck.store.put_manifest = lambda *a, **kw: (_ for _ in ()).throw(
        IOError("disk full"))
    ck.save({"w": w, "step": 2})                   # body fails
    deadline = time.monotonic() + JOIN_S
    while ck.saver.busy and time.monotonic() < deadline:
        time.sleep(0.005)
    ck.store.put_manifest = orig
    with pytest.raises(IOError):
        ck.save({"w": w, "step": 3})               # dropped at submit
    t = ck.save({"w": w, "step": 3})
    ck.wait()
    got = ck.load(time_id=t)
    assert got["step"] == 3 and torch.equal(got["w"], w)
    assert ck.saver.n_failed == 1


# ---------------------------------------------------------------------------
# on the card: the side stream and the caller's stream
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the async body's side stream and "
                    "the fingerprint kernels run only on the card")
    return torch.device("cuda")


def test_async_inplace_on_caller_stream_on_card(cuda):
    rng = np.random.default_rng(26)
    np_state = base_state(rng, rows=4096)
    state = _to(to_torch(np_state), cuda)
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 12, device=cuda,
                  async_mode=True)
    snaps = {}
    for r in range(4):
        snaps[ck.save(state)] = snapshot_state(np_state)
        sparse_mutate_state(np_state, rng, r + 1)
        state["params"]["emb"].copy_(np_to_torch(np_state["params"]["emb"]))
        state["step"] = np_state["step"]
    ck.wait()
    assert ck.save_stats[-1]["n_digest_syncs"] == 1
    for tid, snap in snaps.items():
        got = ck.load(time_id=tid)
        assert tree_equal(from_torch(_to(got, "cpu")), snap), tid
    assert ck.close() == []


def _to(tree, device, memo=None):
    memo = {} if memo is None else memo
    if isinstance(tree, dict):
        return {k: _to(v, device, memo) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        if id(tree) not in memo:
            memo[id(tree)] = tree.to(device)
        return memo[id(tree)]
    return tree
