"""Port checkout / diff / gc / refcounts / fsck vs the reference package.

One seeded sequence of calls goes through the reference `Chipmink` (JAX
leaves, the jnp reference path) and the port (`device="cpu"`, the
kernels' plain versions) in lockstep.  After every step the two stores
must be byte-identical: every manifest (minus the timing `stats`), every
pod's stored bytes in each physical form (whole and delta), and the
refs, refcount-index, TimeID-counter and lease meta blobs.  `GCStats`,
freed digest sets, checkout statistics and `fsck` reports must match,
and every restored state must equal the snapshot taken when it was
committed.  Tolerance zero throughout.

`PairWorkload` is the port's counterpart of `proptest.VersionWorkload`
(which builds reference instances only): random mutate / commit / branch
/ checkout / drop-branch+gc / evict rounds, each verified as above.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import BundleAll as RefBundleAll
from repro.core import Chipmink as RefChipmink
from repro.core import FileStore as RefFileStore
from repro.core import MemoryStore as RefMemoryStore
from repro.version import fsck as ref_fsck
from repro_torch.core import BundleAll, Chipmink, FileStore, MemoryStore
from repro_torch.version import fsck as port_fsck
from repro_torch.version import mark_and_sweep

from proptest import (base_state, case_rng, mutate_state, snapshot_state,
                      sparse_mutate_state, tree_equal)
from test_torch_checkpoint import (assert_loaded_equal, convert, to_jax,
                                   to_torch, torch_to_np)

#: counters and timers of the reference package's manifest stats block
#: that the port's manifests do not keep (nothing reads them)
UNKEPT_STATS = ("t_graph_inc", "n_nodes_reused", "n_nodes_rebuilt",
                "n_fused_rows", "n_pod_digests_reused")


@pytest.fixture
def reference_stats_block_as_the_port(monkeypatch):
    """The reference package writes its manifests without the stats the
    port's leave out, so the two packages' manifests of one save are of
    one size and their stores' byte counts compare.  Nothing else of a
    manifest changes.  Modules that compare store byte counts import
    this fixture by name and use it in their `pytestmark`."""
    from repro.core import faults, store

    def dropping(put):
        def put_manifest(self, time_id, manifest):
            if "stats" in manifest:
                manifest = dict(manifest, stats={
                    k: v for k, v in manifest["stats"].items()
                    if k not in UNKEPT_STATS})
            return put(self, time_id, manifest)
        return put_manifest

    for cls in (store.BaseStore, faults.FaultyStore):
        monkeypatch.setattr(cls, "put_manifest",
                            dropping(cls.put_manifest))


pytestmark = pytest.mark.usefixtures("reference_stats_block_as_the_port")

#: meta blobs both packages write; all must be byte-identical
META_KEYS = ("refs", "pod_refcounts", "tid_counter", "leases")
#: report fields that are timings, not results
TIMING_FIELDS = ("t_scan", "t_repair", "t_restore", "t_prime")


def from_torch(tree):
    """Port state (tensors) -> numpy copies, keeping aliases as one
    object, so the workload can mutate it without touching the port's
    live tensors."""
    return convert(tree, lambda t: (torch_to_np(t).copy()
                                    if isinstance(t, torch.Tensor)
                                    else np.array(t)))


def strip_stats(manifest):
    return {k: v for k, v in manifest.items() if k != "stats"}


def results(obj):
    """A report dataclass as a dict, minus timings, lists sorted."""
    d = dataclasses.asdict(obj)
    for k in TIMING_FIELDS:
        d.pop(k, None)
    return {k: sorted(v) if isinstance(v, list) else v for k, v in d.items()}


def assert_stores_equal(rs, ps, meta_keys=META_KEYS):
    """Byte-identical stores: manifests (minus stats, with ``delta_of``),
    pods in both physical forms, meta blobs."""
    tids = rs.list_time_ids()
    assert tids == ps.list_time_ids()
    for t in tids:
        assert strip_stats(rs.get_manifest(t)) == \
            strip_stats(ps.get_manifest(t)), t
    assert sorted(rs.list_pods()) == sorted(ps.list_pods())
    for d in rs.list_pods():
        assert rs._has_whole(d) == ps._has_whole(d), d
        if rs._has_whole(d):
            assert rs._get_raw(d) == ps._get_raw(d), d
    assert sorted(rs.list_delta_pods()) == sorted(ps.list_delta_pods())
    for d in rs.list_delta_pods():
        assert rs._get_delta_raw(d) == ps._get_delta_raw(d), d
    for key in meta_keys:
        assert rs.get_meta(key) == ps.get_meta(key), key


class PairWorkload:
    """Seeded workload driven through both packages in lockstep.

    ``kw`` configures both `Chipmink`s alike (``delta_chains``,
    ``refcounts``, ...), ``ref_kw`` / ``port_kw`` each one alone (objects
    of a package's own classes, such as a `DeltaPolicy`); ``policy`` is a
    (reference, port) pair of zero-arg factories.  The workload state is numpy; each save converts
    it afresh (aliases kept), each checkout converts the port's result
    back."""

    def __init__(self, rng, *, rows=128, chunk_bytes=1 << 10, stores=None,
                 policy=None, mutate=mutate_state, ref_kw=None, port_kw=None,
                 **kw):
        rs, ps = stores if stores is not None else (RefMemoryStore(),
                                                    MemoryStore())
        self.rng = rng
        self.mutate_fn = mutate
        pol = {} if policy is None else {"r": policy[0], "p": policy[1]}
        self.ref = RefChipmink(rs, chunk_bytes=chunk_bytes, use_kernel=False,
                               policy=pol["r"]() if pol else None,
                               **kw, **(ref_kw or {}))
        self.port = Chipmink(ps, chunk_bytes=chunk_bytes, device="cpu",
                             policy=pol["p"]() if pol else None,
                             **kw, **(port_kw or {}))
        self.state = base_state(rng, rows=rows)
        self.commits = {}
        self.round_no = 0
        self._n_branch = 0
        self.n_evicted = 0

    def check(self):
        assert_stores_equal(self.ref.store, self.port.store)

    def mutate(self):
        self.round_no += 1
        return self.mutate_fn(self.state, self.rng, self.round_no)

    def commit(self):
        tr = self.ref.save(to_jax(self.state))
        tp = self.port.save(to_torch(self.state))
        self.ref.wait()
        self.port.wait()
        assert tr == tp
        self.commits[tp] = snapshot_state(self.state)
        self.check()
        return tp

    def branch(self):
        self._n_branch += 1
        name = f"b{self._n_branch}"
        assert self.ref.branch(name) == self.port.branch(name)
        self.check()
        return name

    def checkout(self, ref):
        sr = self.ref.checkout(ref)
        sp = self.port.checkout(ref)
        tid = self.port.versions.resolve(ref)
        want = results(self.ref.last_checkout_stats)
        got = results(self.port.last_checkout_stats)
        # the port's own fields: its live tensors were never changed in
        # place (every save converts the workload state afresh)
        assert got.pop("n_dirty_chunks") == 0
        got.pop("n_syncs")
        assert want == got
        got = from_torch(sp)
        assert tree_equal(got, convert(sr, np.asarray))
        if tid in self.commits:
            assert tree_equal(got, self.commits[tid])
        self.state = got
        self.check()
        return sp

    def other_branches(self):
        dag = self.port.versions
        return sorted(b for b in dag.branches if b != dag.head_branch)

    def drop_branch_and_gc(self):
        names = self.other_branches()
        if names:
            name = names[int(self.rng.integers(0, len(names)))]
            self.ref.delete_branch(name)
            self.port.delete_branch(name)
        dry_r, dry_p = self.ref.gc(dry_run=True), self.port.gc(dry_run=True)
        assert results(dry_r) == results(dry_p)
        total0 = self.port.store.total_bytes()
        real_r, real_p = self.ref.gc(), self.port.gc()
        assert results(real_r) == results(real_p)
        assert real_p.bytes_reclaimed == dry_p.bytes_reclaimed
        assert total0 - self.port.store.total_bytes() == \
            real_p.bytes_reclaimed
        self.check()
        self.verify_live()
        return real_p

    def evict(self):
        names = self.other_branches()
        if not names:
            return None
        name = names[int(self.rng.integers(0, len(names)))]
        dry = self.port.evict_branch(name, dry_run=True)
        got_r, got_p = self.ref.evict_branch(name), self.port.evict_branch(name)
        assert results(got_r) == results(got_p)
        assert sorted(dry.deleted_pod_digests) == \
            sorted(got_p.deleted_pod_digests)
        # what a full mark-and-sweep would still free: nothing
        left = mark_and_sweep(self.port.store, self.port.versions,
                              extra_roots=(self.port.lineage.head,),
                              dry_run=True)
        assert left.n_pods_deleted == 0 and left.n_commits_deleted == 0
        assert not self.port.refcounts.rebuild()     # index == store scan
        self.check()
        self.n_evicted += 1
        return got_p

    def verify_live(self):
        live = set(self.port.store.list_time_ids())
        for tid, snap in self.commits.items():
            if tid in live:
                assert tree_equal(from_torch(self.port.load(time_id=tid)),
                                  snap), tid

    def run(self, n_rounds, *, p_branch=0.15, p_checkout=0.25, p_gc=0.15,
            p_evict=0.0):
        for _ in range(n_rounds):
            r = float(self.rng.random())
            if r < p_branch and self.commits:
                self.mutate()
                self.branch()
                self.commit()
            elif r < p_branch + p_checkout and self.commits:
                if p_evict:
                    # branch tips only: a detached commit would leave
                    # garbage no branch eviction accounts for
                    cand = sorted(self.port.versions.branches)
                else:
                    live = set(self.port.store.list_time_ids())
                    cand = sorted(t for t in self.commits if t in live)
                self.checkout(cand[int(self.rng.integers(0, len(cand)))])
                self.mutate()
                self.commit()
            elif r < p_branch + p_checkout + p_gc and len(self.commits) > 2:
                self.drop_branch_and_gc()
            elif (p_evict and self.other_branches()
                  and r < p_branch + p_checkout + p_gc + p_evict):
                self.evict()
            else:
                self.mutate()
                self.commit()
        self.verify_live()
        self.close()

    def close(self):
        assert self.ref.close() == [] and self.port.close() == []


# ---------------------------------------------------------------------------
# randomized lockstep workloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(3))
def test_version_workload_matches_reference(case):
    rng = case_rng("test_version_workload_matches_reference", case)
    wl = PairWorkload(rng)
    wl.run(8)
    assert len(wl.commits) >= 3


@pytest.mark.parametrize("case", range(2))
def test_refcount_workload_matches_reference(case):
    """``refcounts=True`` with evictions: the index blob, every
    eviction's GCStats and the store stay byte-identical, and each
    eviction frees exactly what mark-and-sweep would."""
    rng = case_rng("test_refcount_workload_matches_reference", case)
    wl = PairWorkload(rng, refcounts=True)
    wl.run(12, p_branch=0.35, p_gc=0.1, p_evict=0.25)
    assert wl.n_evicted >= 1


def test_async_workload_matches_reference():
    rng = case_rng("test_async_workload_matches_reference", 0)
    wl = PairWorkload(rng, async_mode=True)
    wl.run(8)


# ---------------------------------------------------------------------------
# checkout: live-object reuse, store reads, priming
# ---------------------------------------------------------------------------

def _tensor_state(rng, rows=256):
    return to_torch(base_state(rng, rows=rows))


def test_checkout_hands_back_live_tensors_and_reads_the_delta():
    rng = np.random.default_rng(2)
    state = _tensor_state(rng, rows=512)
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 10, device="cpu")
    ck.save(state)
    ck.branch("exp")
    for r in range(3):
        state["params"]["emb"][7 + r] += 1.0
        state["step"] = r + 1
        ck.save(state)
    r0 = ck.store.stats.read_bytes
    out = ck.checkout("main")
    cs = ck.last_checkout_stats
    # untouched leaves (w, nested/a, opt/mu) come back as the live
    # objects; emb (and its alias) is restored from the store
    for path in (("params", "w"), ("params", "nested", "a"), ("opt", "mu")):
        got, live = out, state
        for p in path:
            got, live = got[p], live[p]
        assert got is live, path
    assert cs.n_leaves_reused == 3
    assert out["params"]["emb"] is not state["params"]["emb"]
    assert out["params"]["tied"] is out["params"]["emb"]
    assert 0 < ck.store.stats.read_bytes - r0 == cs.read_bytes
    assert cs.n_pods_fetched < cs.n_pods
    # restored tensors are writable, on the instance's device
    out["params"]["emb"][0] += 1.0
    assert out["params"]["emb"].device == ck.device
    # the next save is incremental and pays exactly one fetch
    from repro_torch.kernels import ops as tops
    f0 = tops.fetch_count
    ck.save(out)
    st = ck.save_stats[-1]
    assert st["n_pods_reused"] > 0 and tops.fetch_count - f0 == 1
    assert st["n_digest_syncs"] == 1


def test_checkout_store_reads_scale_with_the_delta():
    rng = np.random.default_rng(3)
    state = _tensor_state(rng, rows=1024)
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 10, device="cpu")
    t1 = ck.save(state)
    ck.branch("exp")
    state["params"]["emb"][5] += 1.0
    ck.save(state)
    ck.checkout("main")
    delta_read = ck.last_checkout_stats.read_bytes
    cold = Chipmink(ck.store, chunk_bytes=1 << 10, device="cpu",
                    fsck_on_open=False)
    r0 = cold.store.stats.read_bytes
    cold.load(time_id=t1)
    full_read = cold.store.stats.read_bytes - r0
    assert 0 < delta_read * 10 < full_read, (delta_read, full_read)


@pytest.mark.parametrize("async_mode", [False, True])
@pytest.mark.parametrize("switch", [False, True])
def test_checkout_after_in_place_update_restores_the_commit(async_mode,
                                                            switch):
    """Tensors changed in place after the last save (one row of ``w``,
    every chunk of ``mu``) are not taken from memory: checkout restores
    the commit bit-exact, as the reference does, both from the saved
    state and, in a second round, from a checked-out state changed in
    place.  Untouched leaves still come back as the live objects, and
    the next save lands the same commit in both packages with one
    fetch."""
    from repro_torch.kernels import ops as tops
    rng = np.random.default_rng(21)
    np_state = base_state(rng, rows=512)
    ref = RefChipmink(RefMemoryStore(), chunk_bytes=1 << 10,
                      use_kernel=False, async_mode=async_mode)
    port = Chipmink(MemoryStore(), chunk_bytes=1 << 10, device="cpu",
                    async_mode=async_mode)
    live = to_torch(np_state)
    commit = snapshot_state(np_state)
    assert ref.save(to_jax(np_state)) == port.save(live)
    if switch:
        assert ref.branch("exp") == port.branch("exp")
        live["params"]["emb"][5] += 1.0
        assert ref.save(to_jax(from_torch(live))) == port.save(live)
    for round_no in range(2):
        live["params"]["w"][3] += 1.0
        live["opt"]["mu"].add_(1.0)
        got, want = port.checkout("main"), ref.checkout("main")
        cs = port.last_checkout_stats
        assert tree_equal(from_torch(got), commit)
        assert tree_equal(from_torch(got), convert(want, np.asarray))
        for path in (("params", "w"), ("opt", "mu")):
            assert got[path[0]][path[1]] is not live[path[0]][path[1]]
        # after an async save the live graph holds the save's snapshot,
        # which the caller's in-place update never reached
        changed = not async_mode or round_no > 0
        assert (cs.n_dirty_chunks > 0) == changed
        assert (got["params"]["nested"]["a"]
                is live["params"]["nested"]["a"]) == changed
        assert cs.n_leaves_reused >= 1
        live = got
    got["params"]["emb"][0] += 1.0
    f0 = tops.fetch_count
    tp = port.save(got)
    port.wait()
    if not async_mode:
        assert tops.fetch_count - f0 == 1
    assert port.save_stats[-1]["n_digest_syncs"] == 1
    assert port.save_stats[-1]["n_pods_reused"] > 0
    assert ref.save(to_jax(from_torch(got))) == tp
    ref.wait()
    assert_stores_equal(ref.store, port.store)
    assert ref.close() == [] and port.close() == []


def test_checkout_after_in_place_reshape_takes_nothing_from_memory():
    """A live tensor whose shape changed in place (``.data =``) no longer
    fits its leaf's chunk layout: checkout then serves nothing from
    memory and restores the commit from the store."""
    rng = np.random.default_rng(24)
    np_state = base_state(rng, rows=256)
    live = to_torch(np_state)
    ck = Chipmink(MemoryStore(), chunk_bytes=1 << 10, device="cpu")
    ck.save(live)
    live["params"]["w"].data = torch.zeros(16, 32)
    got = ck.checkout("main")
    cs = ck.last_checkout_stats
    assert tree_equal(from_torch(got), snapshot_state(np_state))
    assert cs.n_leaves_reused == 0 and cs.n_pods_fetched == cs.n_pods


def test_checkout_legacy_manifest_without_chunk_table():
    """A manifest without the chunk table re-fingerprints the restored
    state once (the K2 / plain digest path) and still primes reuse."""
    rng = np.random.default_rng(7)
    state = base_state(rng, rows=256)
    pair = PairWorkload(rng)
    pair.state = state
    t1 = pair.commit()
    for store in (pair.ref.store, pair.port.store):
        m = store.get_manifest(t1)
        del m["chunks"]
        store.put_manifest(t1, m)
    r2 = RefChipmink(pair.ref.store, chunk_bytes=1 << 10, use_kernel=False)
    p2 = Chipmink(pair.port.store, chunk_bytes=1 << 10, device="cpu")
    sr, sp = r2.checkout(t1), p2.checkout(t1)
    assert not p2.last_checkout_stats.digest_table_imported
    assert tree_equal(from_torch(sp), convert(sr, np.asarray))
    sp["params"]["emb"][0] += 1.0
    sr = convert(from_torch(sp), np.asarray)
    tr, tp = r2.save(to_jax(sr)), p2.save(sp)
    assert p2.save_stats[-1]["n_pods_reused"] > 0
    assert tr == tp
    assert_stores_equal(r2.store, p2.store)


def test_diff_matches_reference():
    rng = case_rng("test_diff_matches_reference", 0)
    wl = PairWorkload(rng)
    wl.commit()
    wl.branch()
    for _ in range(2):
        sparse_mutate_state(wl.state, rng, wl.round_no + 1)
        wl.commit()
    da, db = wl.ref.diff("main", "b1"), wl.port.diff("main", "b1")
    assert dataclasses.asdict(da) == dataclasses.asdict(db)
    assert da.only_b and da.shared


# ---------------------------------------------------------------------------
# gc
# ---------------------------------------------------------------------------

def test_gc_reclaim_matches_full_mark_and_sweep_and_reference():
    rng = case_rng("test_gc_reclaim", 0)
    wl = PairWorkload(rng)
    wl.commit()
    for _ in range(2):
        wl.branch()
        for _ in range(2):
            wl.mutate()
            wl.commit()
        wl.checkout("main")
    st = wl.drop_branch_and_gc()
    assert st.n_pods_deleted > 0
    wl.close()


# ---------------------------------------------------------------------------
# cross-package stores: checkout + fsck in the other package
# ---------------------------------------------------------------------------

def _write_feature_store(pkg, root, rng):
    """A history with every storage feature: delta chains, refcounts,
    writer leases (released on close), a branch and a tag."""
    if pkg == "ref":
        ck = RefChipmink(RefFileStore(root), RefBundleAll(),
                         chunk_bytes=1 << 10, use_kernel=False,
                         delta_chains=True, refcounts=True,
                         multi_writer=True, lease_heartbeat=False)
        conv = to_jax
    else:
        ck = Chipmink(FileStore(root), BundleAll(), chunk_bytes=1 << 10,
                      device="cpu", delta_chains=True, refcounts=True,
                      multi_writer=True, lease_heartbeat=False)
        conv = to_torch
    state = base_state(rng, rows=256)
    snaps = {}
    snaps[ck.save(conv(state))] = snapshot_state(state)
    ck.tag("v0")
    for r in range(1, 4):
        sparse_mutate_state(state, rng, r)
        snaps[ck.save(conv(state))] = snapshot_state(state)
    ck.branch("exp")
    sparse_mutate_state(state, rng, 9)
    snaps[ck.save(conv(state))] = snapshot_state(state)
    assert any(s["n_delta_pods"] for s in ck.save_stats)
    assert ck.close() == []
    return snaps


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_feature_store_checks_out_and_fscks_across_packages(tmp_path,
                                                           writer):
    rng = np.random.default_rng(11)
    root = str(tmp_path / "s")
    snaps = _write_feature_store(writer, root, rng)
    # fsck reports agree, deep and quick
    for deep in (False, True):
        rr = ref_fsck(RefFileStore(root), deep=deep, repair=False)
        rp = port_fsck(FileStore(root), deep=deep, repair=False)
        assert results(rr) == results(rp) and rp.clean
    if writer == "ref":
        reader = Chipmink(FileStore(root), chunk_bytes=1 << 10,
                          device="cpu", refcounts=True, multi_writer=True,
                          lease_heartbeat=False, fsck_on_open="deep")
        for tid, snap in snaps.items():
            got = reader.checkout(tid)
            assert tree_equal(from_torch(got), snap), tid
        assert reader.close() == []
    else:
        reader = RefChipmink(RefFileStore(root), chunk_bytes=1 << 10,
                             use_kernel=False, refcounts=True,
                             multi_writer=True, lease_heartbeat=False,
                             fsck_on_open="deep")
        for tid, snap in snaps.items():
            got = reader.checkout(tid)
            assert tree_equal(convert(got, np.asarray), snap), tid
        assert reader.close() == []


def test_feature_stores_are_byte_identical(tmp_path):
    """The same history written by each package: identical stores,
    meta blobs included (leases are released on close)."""
    sr = _write_feature_store("ref", str(tmp_path / "r"),
                              np.random.default_rng(12))
    sp = _write_feature_store("port", str(tmp_path / "p"),
                              np.random.default_rng(12))
    assert sr.keys() == sp.keys()
    assert_stores_equal(RefFileStore(str(tmp_path / "r")),
                        FileStore(str(tmp_path / "p")))


def test_checkout_then_save_matches_reference_on_tensor_leaves():
    """Checkout restores bf16 / int / bool leaves and aliases; the next
    save lands the same commit in both packages."""
    from test_torch_checkpoint import _mixed_state
    rng = np.random.default_rng(13)
    state = _mixed_state(rng)
    ref = RefChipmink(RefMemoryStore(), chunk_bytes=1 << 10)
    port = Chipmink(MemoryStore(), chunk_bytes=1 << 10, device="cpu")
    t1 = ref.save(to_jax(state))
    assert port.save(to_torch(state)) == t1
    state2 = dict(state, emb=state["emb"] + 1.0)
    state2["tied"] = state2["emb"]
    ref.branch("x")
    port.branch("x")
    assert ref.save(to_jax(state2)) == port.save(to_torch(state2))
    got = port.checkout("main")
    ref.checkout("main")
    assert_loaded_equal(got, state)
    assert got["tied"] is got["emb"]
    got["emb"][0] += 2.0
    back = from_torch(got)
    assert ref.save(to_jax(back)) == port.save(got)
    assert_stores_equal(ref.store, port.store)
