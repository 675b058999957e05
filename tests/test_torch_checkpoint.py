"""Port `Chipmink` vs the reference over the same mutation sequences.

Manifests (minus the timing `stats`) and pod bytes must be identical,
the sync counts (`n_digest_syncs`, `n_gather_syncs`,
`n_corrective_syncs`) equal, and a `FileStore` written by either package
must load bit-exactly in the other.  The port runs with ``device="cpu"``
(the kernels' plain versions); its blocking fetches are counted by
`repro_torch.kernels.ops.fetch_count`, the reference's by wrapping
`jax.device_get`.
"""
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.core.change_detector import ChangeDetector as RefDetector
from repro.core.checkpoint import Chipmink as RefChipmink
from repro.core.lga import BundleAll
from repro.core.store import FileStore as RefFileStore
from repro.core.store import MemoryStore as RefMemoryStore
from repro_torch.core import Chipmink, FileStore, MemoryStore, reflow
from repro_torch.core.graph import torch_dtype
from repro_torch.kernels import ops as tops

from proptest import (base_state, mutate_state, sparse_mutate_state,
                      strip_manifest)

SYNC_STATS = ("n_digest_syncs", "n_gather_syncs", "n_corrective_syncs",
              "n_spec_hits", "n_spec_misses", "pods_written", "n_dirty_chunks")


def np_to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy (bfloat16 via its uint16 bits) -> CPU tensor, same bytes."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def torch_to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(jnp.bfloat16)
    return t.numpy()


def convert(tree, leaf, memo=None):
    """Map array leaves through `leaf`, keeping object identity (aliases)."""
    memo = {} if memo is None else memo
    if isinstance(tree, dict):
        return {k: convert(v, leaf, memo) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        if id(tree) not in memo:
            memo[id(tree)] = leaf(tree)
        return memo[id(tree)]
    return tree


def to_torch(tree):
    return convert(tree, np_to_torch)


def to_jax(tree):
    # 64-bit leaves stay numpy: jax without x64 would narrow them to 32 bits
    return convert(tree, lambda a: a if a.dtype.itemsize == 8
                   else jnp.asarray(a))


def assert_loaded_equal(got, want):
    """`got` (port load: tensors) holds `want`'s (numpy) keys and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            assert_loaded_equal(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert isinstance(got, torch.Tensor)
        assert got.dtype == torch_dtype(str(want.dtype))
        assert tuple(got.shape) == want.shape
        assert torch_to_np(got).tobytes() == want.tobytes()
    else:
        assert got == want


class DeviceGetCounter:
    """Counts the reference's blocking `jax.device_get` calls."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = jax.device_get

        def counted(x):
            self.n += 1
            return real(x)

        monkeypatch.setattr(jax, "device_get", counted)


def _pair(rung, chunk_bytes=1 << 12, ref_store=None, port_store=None):
    kw = {"fused": {}, "two_sync": {"fused": False},
          "per_leaf": {"fused": False}, "scratch": {"incremental": False}}[rung]
    ref = RefChipmink(ref_store or RefMemoryStore(), chunk_bytes=chunk_bytes,
                      **kw)
    port = Chipmink(port_store or MemoryStore(), chunk_bytes=chunk_bytes,
                    device="cpu", batched=rung != "per_leaf", **kw)
    if rung == "per_leaf":
        ref.detector = RefDetector(chunk_bytes=chunk_bytes, fused=False,
                                   batched=False)
    return ref, port


def _assert_same_commit(ref, port, tid_ref, tid_port):
    mr, mp = ref.store.get_manifest(tid_ref), port.store.get_manifest(tid_port)
    assert strip_manifest(mr) == strip_manifest(mp)
    for meta in mr["pods"].values():
        assert ref.store.get_pod(meta["d"]) == port.store.get_pod(meta["d"])
    sr, sp = ref.save_stats[-1], port.save_stats[-1]
    assert {k: sr.get(k) for k in SYNC_STATS} == \
        {k: sp.get(k) for k in SYNC_STATS}


@pytest.mark.parametrize("rung", ["fused", "two_sync", "per_leaf",
                                  "scratch"])
@pytest.mark.parametrize("seed", [0, 1])
def test_manifests_and_pods_match_reference(rung, seed):
    rng = np.random.default_rng(seed)
    state = base_state(rng, rows=256)
    ref, port = _pair(rung)
    for r in range(6):
        tag = "bootstrap"
        if r:
            tag = (sparse_mutate_state if r % 2 else mutate_state)(
                state, rng, r)
        _assert_same_commit(ref, port, ref.save(to_jax(state)),
                            port.save(to_torch(state)))
    out = port.load()
    assert_loaded_equal(out, {k: v for k, v in state.items()})
    assert out["params"]["tied"] is out["params"]["emb"] or \
        state["params"]["tied"] is not state["params"]["emb"], tag


def _mk_states(n=5):
    out = []
    w = np.arange(4000, dtype=np.float32)
    for i in range(n):
        w2 = w.copy()
        w2[:100] += i                     # sparse update: chunk 0 only
        out.append({"params": {"w": w2, "frozen": np.ones((800,), np.float32)},
                    "step": i})
    return out


def test_warm_sparse_save_is_single_sync(monkeypatch):
    sts = _mk_states()
    ref, port = _pair("fused")
    for s in sts[:3]:                     # warm up EMA + device table
        _assert_same_commit(ref, port, ref.save(to_jax(s)),
                            port.save(to_torch(s)))
    counter = DeviceGetCounter(monkeypatch)
    fetches = tops.fetch_count
    _assert_same_commit(ref, port, ref.save(to_jax(sts[3])),
                        port.save(to_torch(sts[3])))
    assert counter.n == 1 and tops.fetch_count - fetches == 1
    s = port.save_stats[-1]
    assert (s["n_digest_syncs"], s["n_gather_syncs"],
            s["n_corrective_syncs"], s["n_spec_misses"],
            s["n_spec_hits"]) == (1, 0, 0, 0, 1)


def test_forced_mispredict_pays_one_corrective_sync(monkeypatch):
    sts = _mk_states()
    ref, port = _pair("fused")
    for s in sts[:4]:                     # 4 saves: frozen EMA ≈ 0.22
        ref.save(to_jax(s))
        port.save(to_torch(s))
    st = dict(sts[4])
    st["params"] = dict(st["params"], frozen=np.zeros((800,), np.float32))
    counter = DeviceGetCounter(monkeypatch)
    fetches = tops.fetch_count
    _assert_same_commit(ref, port, ref.save(to_jax(st)),
                        port.save(to_torch(st)))
    s = port.save_stats[-1]
    assert s["n_spec_misses"] > 0 and s["n_corrective_syncs"] == 1
    assert tops.fetch_count - fetches == counter.n == 2
    out = port.load(time_id=s["time_id"])
    assert torch.equal(out["params"]["frozen"], torch.zeros(800))


def test_all_clean_save_is_single_sync(monkeypatch):
    sts = _mk_states()
    ref, port = _pair("fused")
    ref.save(to_jax(sts[0]))
    port.save(to_torch(sts[0]))
    counter = DeviceGetCounter(monkeypatch)
    fetches = tops.fetch_count
    _assert_same_commit(ref, port, ref.save(to_jax(sts[0])),
                        port.save(to_torch(sts[0])))
    assert counter.n == 1 and tops.fetch_count - fetches == 1
    s = port.save_stats[-1]
    assert s["n_dirty_chunks"] == 0 and s["n_gather_syncs"] == 0


def _mixed_state(rng):
    """Every dtype family, a 0-d leaf, a zero-size leaf and an alias."""
    st = {
        "emb": rng.standard_normal((300, 8)).astype(np.float32),
        "w16": np.asarray(jnp.asarray(rng.standard_normal((33, 7)),
                                      jnp.bfloat16)),
        "h": rng.standard_normal((5, 3)).astype(np.float16),
        "q": rng.integers(-100, 100, (77,)).astype(np.int8),
        "flags": rng.standard_normal(13) > 0,
        "ids": rng.integers(0, 2**40, (9,)).astype(np.int64),
        "scalar": np.asarray(np.float32(2.5)),
        "empty": np.zeros((0, 4), np.float32),
        "step": 3,
    }
    st["tied"] = st["emb"]
    return st


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_filestore_loads_across_packages(tmp_path, direction):
    rng = np.random.default_rng(7)
    state = _mixed_state(rng)
    root = str(tmp_path / "store")
    if direction == "ref_to_port":
        writer = RefChipmink(RefFileStore(root), chunk_bytes=1 << 10)
        t1 = writer.save(to_jax(state))
        state2 = dict(state, emb=state["emb"] + 1.0)
        state2["tied"] = state2["emb"]
        t2 = writer.save(to_jax(state2))
        reader = Chipmink(FileStore(root), chunk_bytes=1 << 10, device="cpu")
        for tid, want in ((t1, state), (t2, state2)):
            got = reader.load(time_id=tid)
            assert_loaded_equal(got, want)
            assert got["tied"] is got["emb"]
        # the reopened port instance appends after the reference's commits
        assert reader.save(to_torch(state2)) == t2 + 1
    else:
        writer = Chipmink(FileStore(root), chunk_bytes=1 << 10, device="cpu")
        t1 = writer.save(to_torch(state))
        reader = RefChipmink(RefFileStore(root), chunk_bytes=1 << 10)
        got = reader.load(time_id=t1)
        for k, v in state.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype and got[k].shape == v.shape
                assert got[k].tobytes() == v.tobytes(), k
            else:
                assert got[k] == v
        assert got["tied"] is got["emb"]


def test_reference_delta_chain_store_loads(tmp_path):
    rng = np.random.default_rng(3)
    state = base_state(rng, rows=256)
    root = str(tmp_path / "store")
    writer = RefChipmink(RefFileStore(root), BundleAll(),
                         chunk_bytes=1 << 10, delta_chains=True)
    tids = [writer.save(to_jax(state))]
    for r in range(1, 4):
        sparse_mutate_state(state, rng, r)
        tids.append(writer.save(to_jax(state)))
    assert any(s["n_delta_pods"] for s in writer.save_stats)
    reader = Chipmink(FileStore(root), chunk_bytes=1 << 10, device="cpu")
    assert_loaded_equal(reader.load(time_id=tids[-1]), state)


def test_load_returns_tensors_on_device_and_reflows():
    rng = np.random.default_rng(5)
    state = _mixed_state(rng)
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 10, device="cpu")
    tid = ck.save(to_torch(state))
    got = ck.load(time_id=tid)
    assert_loaded_equal(got, state)
    assert all(t.device.type == "cpu" for t in got.values()
               if isinstance(t, torch.Tensor))
    part = ck.load(names={"q"}, time_id=tid)
    assert list(part) == ["q"]
    like = {"q": None, "step": None, "nest": [None]}
    out = reflow(like, {"q": got["q"], "step": 3, "nest": {"0": got["h"]}})
    assert isinstance(out["nest"], list) and out["nest"][0] is got["h"]


def test_versioning_surface():
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 10, device="cpu")
    t1 = ck.save({"w": torch.zeros(8)})
    ck.branch("exp")
    t2 = ck.save({"w": torch.ones(8)})
    ck.tag("v1")
    assert [c["time_id"] for c in ck.log()] == [t2, t1]
    assert ck.versions.branches["exp"] == t2
    assert ck.close() == []


@pytest.mark.parametrize("async_mode", [False, True])
def test_tensor_on_other_device_raises(async_mode):
    ck = Chipmink(MemoryStore(), device="cpu", async_mode=async_mode)
    with pytest.raises(ValueError):
        ck.save({"w": torch.zeros(8, device="meta")})
    assert not ck.saver.busy and ck.save_stats == []


def test_stats_manifest_is_msgpack_clean():
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 10, device="cpu")
    tid = ck.save(to_torch(_mixed_state(np.random.default_rng(1))))
    m = ck.store.get_manifest(tid)
    assert msgpack.unpackb(msgpack.packb(m, use_bin_type=True),
                           raw=False) == m
