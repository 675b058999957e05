"""Port delta-chain writes vs the reference package, byte for byte.

The port's store (`put_pod_delta`, `rematerialize_pod`, `pod_chain_depth`,
`pod_whole_nbytes`) and `Chipmink(delta_chains=True)` are driven through
the same calls as the reference's: stored bytes in both physical forms,
``delta_of`` manifest records, store counters, `GCStats` of the
re-materializing collector and `fsck` reports must be identical, and a
delta-chain history must equal the whole-pod from-scratch oracle in every
manifest, pod and load.  Tolerance zero.
"""
import numpy as np
import pytest

from repro.core import BundleAll as RefBundleAll
from repro.core import DeltaPolicy as RefDeltaPolicy
from repro.core import FileStore as RefFileStore
from repro.core import MemoryStore as RefMemoryStore
from repro.version import fsck as ref_fsck
from repro_torch.core import (BundleAll, Chipmink, DeltaPolicy, FileStore,
                              MemoryStore, encode_pod_delta)
from repro_torch.version import fsck as port_fsck

from proptest import (base_state, case_rng, snapshot_state,
                      sparse_mutate_state, strip_manifest, tree_equal)
from test_torch_checkpoint import to_torch
from test_torch_version import (PairWorkload, assert_stores_equal,
                                from_torch, results)

STORE_STATS = ("pods_written", "pod_bytes_written", "delta_pods_written",
               "delta_bytes_written", "chain_reads", "pods_rematerialized",
               "pod_bytes_deleted", "pods_deduped")


def _stores(kind, tmp_path):
    if kind == "memory":
        return RefMemoryStore(), MemoryStore()
    return (RefFileStore(str(tmp_path / "r")),
            FileStore(str(tmp_path / "p")))


def _delta_pair(rng, depth=8, stores=None, **kw):
    return PairWorkload(rng, rows=256, policy=(RefBundleAll, BundleAll),
                        mutate=sparse_mutate_state, delta_chains=True,
                        stores=stores,
                        ref_kw={"delta_policy": RefDeltaPolicy(
                            max_chain_depth=depth)},
                        port_kw={"delta_policy": DeltaPolicy(
                            max_chain_depth=depth)}, **kw)


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_store_delta_methods_match_reference(tmp_path, kind):
    """The same store calls on both packages' backends: identical
    results, stored bytes and counters at every step."""
    import msgpack
    rs, ps = _stores(kind, tmp_path)

    def blob(tag, changed=()):
        entries = [{"k": f"leaf/{i}", "t": "chunk", "r": [],
                    "d": (b"z" if i in changed else tag) * 64}
                   for i in range(5)]
        return msgpack.packb({"pid": 0, "e": entries}, use_bin_type=True)

    base, d1, d2 = "aa" * 16, "bb" * 16, "cc" * 16
    delta1 = encode_pod_delta(blob(b"v", [1]), base, [1])
    delta2 = encode_pod_delta(blob(b"v", [1, 3]), d1, [3])
    for s in (rs, ps):
        assert s.put_pod(base, blob(b"v"))
        assert s.put_pod_delta(d1, delta1)
        assert s.put_pod_delta(d2, delta2)
        assert not s.put_pod_delta(d2, delta2)       # dedup
    for s in (rs, ps):
        assert s.get_pod(d2) == blob(b"v", [1, 3])
    assert rs.pod_chain(d2) == ps.pod_chain(d2) == [d2, d1, base]
    assert rs.pod_chain_depth(d2) == ps.pod_chain_depth(d2) == 2
    assert rs.pod_whole_nbytes(d2) == ps.pod_whole_nbytes(d2) \
        > ps.pod_nbytes(d2)
    assert_stores_equal(rs, ps, meta_keys=())
    assert rs.rematerialize_pod(d1) == ps.rematerialize_pod(d1) > 0
    assert rs.rematerialize_pod(d1) == ps.rematerialize_pod(d1) == 0
    assert rs.delete_pod(base) == ps.delete_pod(base) > 0
    assert rs.get_pod(d2) == ps.get_pod(d2) == blob(b"v", [1, 3])
    assert_stores_equal(rs, ps, meta_keys=())
    assert rs.total_bytes() == ps.total_bytes()
    for k in STORE_STATS:
        assert getattr(rs.stats, k) == getattr(ps.stats, k), k


@pytest.mark.parametrize("depth", [2, 8])
@pytest.mark.parametrize("case", range(2))
def test_delta_saves_match_reference(depth, case):
    """Sparse rounds with delta chains on: identical delta blobs,
    ``delta_of`` records and chain depths, capped at the policy."""
    rng = case_rng("test_delta_saves_match_reference", case)
    wl = _delta_pair(rng, depth=depth)
    for _ in range(depth + 3):
        wl.mutate()
        wl.commit()
    n_delta = [s["n_delta_pods"] for s in wl.port.save_stats]
    assert n_delta == [s["n_delta_pods"] for s in wl.ref.save_stats]
    assert sum(n_delta) > 0
    assert 0 in n_delta[1:]                     # the depth-cap fallback
    for d in wl.port.store.list_delta_pods():
        assert wl.port.store.pod_chain_depth(d) <= depth
    wl.verify_live()
    wl.close()


def test_delta_history_equals_whole_pod_oracle():
    """Delta chains are a storage form only: every manifest (minus
    stats and ``delta_of``), pod and load equals the from-scratch
    whole-pod oracle's."""
    rng = np.random.default_rng(4)
    state = base_state(rng, rows=512)
    ck = Chipmink(MemoryStore(), BundleAll(), chunk_bytes=1 << 10,
                  device="cpu", delta_chains=True)
    oracle = Chipmink(MemoryStore(), BundleAll(), chunk_bytes=1 << 10,
                      device="cpu", incremental=False, delta_chains=False)
    snaps = {}
    for r in range(6):
        if r:
            sparse_mutate_state(state, rng, r)
        t = ck.save(to_torch(state))
        assert oracle.save(to_torch(state)) == t
        snaps[t] = snapshot_state(state)
    assert ck.store.stats.delta_pods_written > 0
    assert oracle.store.list_delta_pods() == []
    for t, snap in snaps.items():
        m, mo = ck.store.get_manifest(t), oracle.store.get_manifest(t)
        assert strip_manifest(m) == strip_manifest(mo)
        for meta in m["pods"].values():
            assert ck.store.get_pod(meta["d"]) == \
                oracle.store.get_pod(meta["d"])
        assert tree_equal(from_torch(ck.load(time_id=t)), snap)
        assert tree_equal(from_torch(oracle.load(time_id=t)), snap)
    mid = ck.checkout(sorted(snaps)[3])
    assert ck.last_checkout_stats.n_chain_reads > 0
    assert tree_equal(from_torch(mid), snaps[sorted(snaps)[3]])


def test_gc_rematerializes_live_delta_like_reference():
    """main t1 → branch "dead" (t2 = Δt1, t3 = Δt2) → main replays the
    same rows so its save dedups onto t3's delta pod; deleting "dead"
    kills the mid-chain base.  Both packages rescue the same pods with
    the same bytes, and GCStats (dry and real) match."""
    wl = _delta_pair(np.random.default_rng(3))
    wl.state = base_state(np.random.default_rng(3), rows=512)
    wl.commit()
    wl.branch()
    mrng = np.random.default_rng(42)
    for r in (1, 2):
        sparse_mutate_state(wl.state, mrng, r)
        wl.commit()
    wl.checkout("main")
    mrng = np.random.default_rng(42)
    for r in (1, 2):
        sparse_mutate_state(wl.state, mrng, r)
    wl.commit()
    wl.ref.delete_branch("b1")
    wl.port.delete_branch("b1")
    dry = wl.port.gc(dry_run=True)
    assert dry.n_pods_rematerialized >= 1
    st = wl.drop_branch_and_gc()
    assert st.n_pods_rematerialized == dry.n_pods_rematerialized
    assert st.n_commits_deleted == 2
    assert wl.port.store.stats.pods_rematerialized >= 1
    wl.close()


def test_fsck_broken_chain_rolls_back_like_reference(tmp_path):
    rng = np.random.default_rng(5)
    wl = _delta_pair(rng, stores=_stores("file", tmp_path))
    wl.state = base_state(rng, rows=512)
    t1 = wl.commit()
    wl.state["params"]["fresh"] = rng.standard_normal((64, 8)).astype(
        np.float32)
    wl.commit()                              # structural: pods whole
    sparse_mutate_state(wl.state, rng, 3)
    t3 = wl.commit()                         # delta against t2's pod
    assert wl.port.save_stats[-1]["n_delta_pods"] >= 1
    base = next(m["delta_of"] for m in
                wl.port.store.get_manifest(t3)["pods"].values()
                if "delta_of" in m)
    wl.close()
    rs, ps = RefFileStore(str(tmp_path / "r")), FileStore(str(tmp_path / "p"))
    rs.delete_pod(base)
    ps.delete_pod(base)
    rr, rp = ref_fsck(rs, repair=False), port_fsck(ps, repair=False)
    assert results(rr) == results(rp) and t3 in rp.incomplete
    rr, rp = ref_fsck(rs), port_fsck(ps)
    assert results(rr) == results(rp)
    assert rp.refs_rolled_back["branch:main"] == (t3, t1)
    assert_stores_equal(rs, ps)


def test_fsck_heals_torn_rematerialization_like_reference(tmp_path):
    rng = np.random.default_rng(6)
    wl = _delta_pair(rng, stores=_stores("file", tmp_path))
    for _ in range(3):
        wl.mutate()
        wl.commit()
    wl.close()
    rs, ps = RefFileStore(str(tmp_path / "r")), FileStore(str(tmp_path / "p"))
    victim = ps.list_delta_pods()[0]
    good = ps.get_pod(victim)
    for s in (rs, ps):
        s._put_raw(victim, b"\x01trunc")     # torn whole form shadows
    rr, rp = ref_fsck(rs, deep=True), port_fsck(ps, deep=True)
    assert results(rr) == results(rp)
    assert victim in rp.whole_forms_dropped
    assert ps.get_pod(victim) == good
    assert_stores_equal(rs, ps)


@pytest.mark.parametrize("case", range(2))
def test_deltachain_workload_matches_reference(case):
    """Random rounds (commit / branch / checkout / drop-branch + gc)
    with delta chains on: stores byte-identical after every step."""
    rng = case_rng("test_deltachain_workload_matches_reference", case)
    wl = _delta_pair(rng, depth=4)
    wl.mutate()
    wl.commit()
    wl.mutate()
    wl.commit()
    wl.run(8)
    assert wl.port.store.stats.delta_pods_written == \
        wl.ref.store.stats.delta_pods_written
