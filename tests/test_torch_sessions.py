"""Port `SessionService` vs the reference package, on the CPU.

`PairSessions` is the port's twin of `proptest.SessionWorkload`: one
seeded sequence of open / fork / mutate+save / resume / evict (and, with
``faulty=True``, crash-mid-evict + reboot) rounds drives the reference's
service (jax leaves, the jnp reference digests) and the port's
(``device="cpu"``, the kernels' plain versions) in lockstep, on
numpy-born identical states.  After every step, tolerance zero:

  * TimeIDs, manifests (minus the timing `stats`), every pod's bytes and
    the refs / refcount-index / TimeID-counter meta blobs are equal;
  * each save's sync counts (`n_digest_syncs`, `n_gather_syncs`,
    `n_corrective_syncs`, ...) are equal;
  * `fleet_stats()` is equal without its timings (in async mode also
    without the store's footprint, which counts the manifests' `stats`);
  * each eviction's `GCStats` and freed digests are equal, and equal the
    mark-and-sweep oracle's;
  * resumed states are equal, and equal the snapshot of their commit.

The rest mirrors the service tests of `tests/test_sessions.py` on the
port, and resumes a `FileStore` written by either package's service in
the other's.
"""
import tempfile

import numpy as np
import pytest
import torch

from repro.core import FaultyStore as RefFaultyStore
from repro.core import FileStore as RefFileStore
from repro.core import InjectedCrash as RefInjectedCrash
from repro.core import MemoryStore as RefMemoryStore
from repro.sessions import SessionService as RefSessionService
from repro.version import mark_and_sweep as ref_mark_and_sweep
from repro_torch.core import (Chipmink, FaultyStore, FileStore, InjectedCrash,
                              MemoryStore)
from repro_torch.sessions import SESSION_NS, SessionService
from repro_torch.version import mark_and_sweep

from proptest import (EVICT_CRASH_POINTS, base_state, case_rng,
                      mutate_state, snapshot_state, sparse_mutate_state,
                      tree_equal)
from test_torch_async import jax_copy
from test_torch_checkpoint import SYNC_STATS, convert, to_torch
from test_torch_version import (assert_stores_equal, from_torch,  # noqa: F401
                                reference_stats_block_as_the_port, results)

pytestmark = pytest.mark.usefixtures("reference_stats_block_as_the_port")

#: `FleetStats` fields that are timings, not results
FLEET_TIMINGS = ("p50_save_stall_s", "p99_save_stall_s", "p50_evict_s",
                 "p99_evict_s")


def fleet(svc, with_manifest_bytes=True):
    """`fleet_stats()` without timings.  Without ``with_manifest_bytes``
    also without the store's footprint, which counts manifest bytes: an
    async save's manifest `stats` block holds the port's snapshot fields
    (`t_snapshot`, `n_snapshot_bytes`), and only `stats` may differ."""
    d = svc.fleet_stats().as_dict()
    for k in FLEET_TIMINGS:
        d.pop(k)
    if not with_manifest_bytes:
        d.pop("store_bytes")
        d.pop("bytes_per_session")
        st = svc.store.stats
        d["pod_bytes"] = st.pod_bytes_written - st.pod_bytes_deleted
    return d


def as_np(tree):
    """A reference state (jax leaves) as numpy, aliases kept."""
    return convert(tree, np.asarray)


def port_svc(store=None, **kw):
    kw.setdefault("pool_size", 2)
    kw.setdefault("chunk_bytes", 1 << 10)
    kw.setdefault("fsck_on_open", False)
    return SessionService(store if store is not None else MemoryStore(),
                          device="cpu", **kw)


def ref_svc(store=None, **kw):
    kw.setdefault("pool_size", 2)
    kw.setdefault("chunk_bytes", 1 << 10)
    kw.setdefault("fsck_on_open", False)
    return RefSessionService(store if store is not None else RefMemoryStore(),
                             use_kernel=False, **kw)


def last_save_stats(svc, sid):
    ck = svc.pool[svc.sessions[sid].slot]
    return {k: ck.save_stats[-1].get(k) for k in SYNC_STATS}


class PairSessions:
    """`proptest.SessionWorkload` through both packages in lockstep."""

    def __init__(self, rng, *, rows=96, chunk_bytes=1 << 10, pool_size=2,
                 max_sessions=6, faulty=False, **kw):
        self.rng = rng
        self.rows = rows
        self.max_sessions = max_sessions
        self.kw = dict(pool_size=pool_size, chunk_bytes=chunk_bytes, **kw)
        self.inner = (RefMemoryStore(), MemoryStore())
        self.faulty = ((RefFaultyStore(self.inner[0]),
                        FaultyStore(self.inner[1])) if faulty else None)
        self.ref, self.port = self._open(fsck_on_open=False)
        #: live session id -> its current numpy state
        self.states = {}
        #: tid -> deep snapshot at commit time
        self.snaps = {}
        self.round_no = 0
        self._sid_counter = 0
        self.n_evicted = self.n_crashed = 0

    def _open(self, fsck_on_open):
        rs, ps = self.faulty if self.faulty else self.inner
        return (ref_svc(rs, fsck_on_open=fsck_on_open, **self.kw),
                port_svc(ps, fsck_on_open=fsck_on_open, **self.kw))

    def _wait(self):
        for ck in self.ref.pool + self.port.pool:
            ck.wait()

    def check(self):
        self._wait()
        assert_stores_equal(*self.inner)
        sync = not self.kw.get("async_mode")
        assert fleet(self.ref, sync) == fleet(self.port, sync)

    def _tip(self, sid):
        ctx = self.port.sessions.get(sid)
        return ctx.head if ctx is not None else None

    def _saved(self):
        return sorted(s for s in self.states if self._tip(s) is not None)

    def _pick(self, sids):
        return sids[int(self.rng.integers(0, len(sids)))]

    def _resume(self, sid):
        sr = self.ref.resume_session(sid)
        sp = self.port.resume_session(sid)
        tip = self._tip(sid)
        assert self.ref.sessions[sid].head == tip
        got = from_torch(sp)
        assert tree_equal(got, as_np(sr)), (self.round_no, sid)
        assert tree_equal(got, self.snaps[tip]), (self.round_no, sid)
        want = results(self.ref.sessions[sid].last_checkout_stats)
        have = results(self.port.sessions[sid].last_checkout_stats)
        # the port's own fields: resume installs fresh per-session state,
        # so there is no previous save to verify live bytes against
        assert have.pop("n_dirty_chunks") == 0
        have.pop("n_syncs")
        assert have == want
        self.states[sid] = got
        return got

    # -- workload steps ------------------------------------------------------
    def open(self):
        self.round_no += 1
        self._sid_counter += 1
        sid = f"s{self._sid_counter}"
        parents = self._saved()
        if parents and float(self.rng.random()) < 0.5:
            ref = SESSION_NS + self._pick(parents)
            self.ref.open_session(sid, from_ref=ref)
            self.port.open_session(sid, from_ref=ref)
            self._resume(sid)
        else:
            self.ref.open_session(sid)
            self.port.open_session(sid)
            self.states[sid] = base_state(self.rng, rows=self.rows)
        self.check()
        return sid

    def save(self, sid=None):
        self.round_no += 1
        if sid is None:
            sid = self._pick(sorted(self.states))
        state = self.states[sid]
        if float(self.rng.random()) < 0.5:
            mutate_state(state, self.rng, self.round_no)
        else:
            sparse_mutate_state(state, self.rng, self.round_no)
        tr = self.ref.save_session(sid, jax_copy(state))
        tp = self.port.save_session(sid, to_torch(state))
        assert tr == tp
        self.check()
        assert last_save_stats(self.ref, sid) == last_save_stats(self.port,
                                                                 sid)
        self.snaps[tp] = snapshot_state(state)
        ck = self.port.pool[self.port.sessions[sid].slot]
        assert tree_equal(from_torch(ck.load(time_id=tp)), self.snaps[tp])
        return tp

    def resume(self):
        self.round_no += 1
        sids = self._saved()
        if sids:
            self._resume(self._pick(sids))
            self.check()

    def _oracle(self, svc, sweep, branch):
        """What a full mark-and-sweep would free after deleting `branch`
        (dry run; the ref is restored), on one package's service."""
        ck0 = svc.pool[0]
        ck0.versions.sync()
        tip = ck0.versions.branches[branch]
        ck0.versions.delete_branch(branch)
        extra = tuple(ck._head for ck in svc.pool
                      if ck._head is not None and ck._head != tip)
        oracle = sweep(svc.store, ck0.versions, extra_roots=extra,
                       dry_run=True)
        ck0.versions.create_branch(branch, at=tip, switch=False)
        return oracle

    def evict(self):
        self.round_no += 1
        sids = self._saved()
        if not sids:
            return None
        sid = self._pick(sids)
        branch = SESSION_NS + sid
        self._wait()
        oracle = self._oracle(self.port, mark_and_sweep, branch)
        assert results(self._oracle(self.ref, ref_mark_and_sweep, branch)) \
            == results(oracle)
        real_r = self.ref.evict_session(sid)
        real_p = self.port.evict_session(sid)
        self.states.pop(sid)
        assert results(real_r) == results(real_p)
        assert sorted(real_p.deleted_pod_digests) == \
            sorted(oracle.deleted_pod_digests)
        assert real_p.bytes_reclaimed == oracle.bytes_reclaimed
        assert real_p.n_commits_deleted == oracle.n_commits_deleted
        left = mark_and_sweep(
            self.port.store, self.port.pool[0].versions, dry_run=True,
            extra_roots=tuple(ck._head for ck in self.port.pool
                              if ck._head is not None))
        assert left.n_pods_deleted == 0 and left.n_commits_deleted == 0
        assert not self.port.pool[0].refcounts.rebuild()
        self.check()
        self.n_evicted += 1
        return real_p

    def crash_evict(self):
        """Kill both evictions at the same armed store write, then reboot
        both services over their stores with a deep fsck."""
        self.round_no += 1
        sids = self._saved()
        if not sids:
            return False
        sid = self._pick(sids)
        point, flavor, skip = EVICT_CRASH_POINTS[
            int(self.rng.integers(0, len(EVICT_CRASH_POINTS)))]
        self._wait()
        crashed = []
        for svc, fs, crash in ((self.ref, self.faulty[0], RefInjectedCrash),
                               (self.port, self.faulty[1], InjectedCrash)):
            fs.clear()
            fs.arm(point, flavor, skip=skip)
            try:
                svc.evict_session(sid)
                crashed.append(False)
            except crash:
                crashed.append(True)
            fs.clear()
        assert crashed[0] == crashed[1], (point, flavor, skip)
        if not crashed[0]:
            self.states.pop(sid)
            self.check()
            return False
        self.n_crashed += 1
        self.ref, self.port = self._open(fsck_on_open="deep")
        assert results(self.ref.pool[0].last_fsck) == \
            results(self.port.pool[0].last_fsck)
        assert not self.port.pool[0].refcounts.rebuild()
        assert results(self.ref.pool[0].gc(full=True)) == \
            results(self.port.pool[0].gc(full=True))
        branches = self.port.pool[0].versions.branches_under(SESSION_NS)
        for s in sorted(self.states):
            if SESSION_NS + s not in branches:
                self.states.pop(s)        # the refs CAS landed: evicted
            else:
                self._resume(s)
        self.check()
        return True

    def verify_live(self):
        ck0 = self.port.pool[0]
        live = set(self.port.store.list_time_ids())
        for tid in sorted(self.snaps):
            if tid in live:
                assert tree_equal(from_torch(ck0.load(time_id=tid)),
                                  self.snaps[tid]), tid
        for sid in self._saved():
            assert self._tip(sid) in live, sid

    def run(self, n_rounds, *, p_open=0.2, p_resume=0.15, p_evict=0.15,
            p_crash=0.0):
        self.open()
        self.open()
        for _ in range(n_rounds):
            r = float(self.rng.random())
            if r < p_open and len(self.states) < self.max_sessions:
                self.open()
            elif r < p_open + p_resume:
                self.resume()
            elif r < p_open + p_resume + p_evict and len(self._saved()) > 1:
                self.evict()
            elif (p_crash and len(self._saved()) > 1
                  and r < p_open + p_resume + p_evict + p_crash):
                self.crash_evict()
            else:
                if not self.states:
                    self.open()
                self.save()
        self.verify_live()
        assert self.ref.close() == [] and self.port.close() == []


# ---------------------------------------------------------------------------
# randomized lockstep fleets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(3))
def test_session_workload_matches_reference(case):
    rng = case_rng("test_session_workload_matches_reference", case)
    wl = PairSessions(rng)
    wl.run(10)
    assert len(wl.snaps) >= 3


@pytest.mark.parametrize("case", range(2))
def test_session_crash_workload_matches_reference(case):
    """Crash mid-evict on both packages at the same store write; both
    reboot through a deep fsck (refcount index rebuilt) and a full GC
    with equal reports, and every surviving session resumes equal."""
    rng = case_rng("test_session_crash_workload_matches_reference", case)
    wl = PairSessions(rng, faulty=True)
    wl.run(10, p_crash=0.3)


def test_session_crash_workload_crashes():
    """The crash rounds above do crash: a seed whose workload reboots."""
    for case in range(6):
        rng = case_rng("test_session_crash_workload_crashes", case)
        wl = PairSessions(rng, faulty=True)
        wl.run(10, p_crash=0.5, p_evict=0.0)
        if wl.n_crashed:
            return
    raise AssertionError("no crash-mid-evict round crashed in 6 seeds")


def test_async_session_workload_matches_reference():
    rng = case_rng("test_async_session_workload_matches_reference", 0)
    wl = PairSessions(rng, async_mode=True)
    wl.run(8)
    assert wl.n_evicted + len(wl.snaps) >= 3


# ---------------------------------------------------------------------------
# the service tests of tests/test_sessions.py, on the port
# ---------------------------------------------------------------------------

def _state(rng, rows=96):
    return to_torch(base_state(rng, rows=rows))


def test_session_lifecycle_and_branches():
    rng = np.random.default_rng(0)
    svc = port_svc()
    svc.open_session("a")
    svc.open_session("b")
    sa, sb = _state(rng), _state(rng)
    ta1 = svc.save_session("a", sa)
    tb1 = svc.save_session("b", sb)
    sa["step"] = 1
    ta2 = svc.save_session("a", sa)

    dag = svc.pool[0].versions
    dag.sync()
    assert dag.branches_under(SESSION_NS) == {SESSION_NS + "a": ta2,
                                              SESSION_NS + "b": tb1}
    assert svc.store.get_manifest(ta2)["parent"] == ta1
    assert svc.store.get_manifest(tb1)["parent"] is None
    assert dag.head_commit() is None
    fleet_ = svc.fleet_stats()
    assert (fleet_.n_sessions, fleet_.n_saves) == (2, 3)
    assert fleet_.logical_tip_bytes > 0 and fleet_.physical_tip_bytes > 0
    # every session digests on the service's device
    for ctx in svc.sessions.values():
        det = ctx.detector if ctx.detector is not None \
            else svc.pool[ctx.slot].detector
        assert det.device == torch.device("cpu")


def test_open_rejects_duplicate_and_existing_branch():
    rng = np.random.default_rng(1)
    svc = port_svc()
    svc.open_session("a")
    st = _state(rng)
    svc.save_session("a", st)
    with pytest.raises(ValueError, match="already open"):
        svc.open_session("a")
    del svc.sessions["a"]
    svc._bound = [None] * len(svc.pool)
    with pytest.raises(ValueError, match="resume_session"):
        svc.open_session("a")
    assert tree_equal(from_torch(svc.resume_session("a")), from_torch(st))


def test_fork_dedups_tip_bytes_as_the_reference():
    """Forks share the parent's tip pod-for-pod; the port's dedup ratio
    equals the reference's before and after one fork diverges."""
    host = base_state(np.random.default_rng(2), rows=256)
    svcs = (ref_svc(), port_svc())
    for svc, conv in zip(svcs, (jax_copy, to_torch)):
        svc.open_session("root")
        svc.save_session("root", conv(host))
        for i in range(4):
            svc.open_session(f"fork{i}", from_ref=SESSION_NS + "root")
    assert svcs[1].fleet_stats().dedup_ratio == pytest.approx(5)
    assert fleet(svcs[0]) == fleet(svcs[1])
    st = from_torch(svcs[1].resume_session("fork0"))
    assert tree_equal(as_np(svcs[0].resume_session("fork0")), st)
    st["params"]["emb"][:2] += np.float32(1.0)
    assert svcs[0].save_session("fork0", jax_copy(st)) == \
        svcs[1].save_session("fork0", to_torch(st))
    assert fleet(svcs[0]) == fleet(svcs[1])
    assert 1.5 < svcs[1].fleet_stats().dedup_ratio


def test_resume_migrates_across_service_instances():
    rng = np.random.default_rng(3)
    store = MemoryStore()
    svc1 = port_svc(store)
    svc1.open_session("a")
    st = _state(rng, rows=256)
    svc1.save_session("a", st)
    st["params"]["emb"][:4] += 0.5
    tip = svc1.save_session("a", st)

    svc2 = port_svc(store)
    restored = svc2.resume_session("a")
    assert tree_equal(from_torch(restored), from_torch(st))
    assert svc2.sessions["a"].head == tip
    restored["params"]["emb"][:2] += 0.25
    tid = svc2.save_session("a", restored)
    assert svc2.store.get_manifest(tid)["parent"] == tip
    tip_bytes = sum(svc2.store.pod_nbytes(d)
                    for d in svc2.pool[0].versions.pod_digests_of(tid))
    last = svc2.pool[svc2.sessions["a"].slot].save_stats[-1]
    assert last["bytes_written"] < tip_bytes / 2
    assert last["n_pods_reused"] > 0
    assert last["n_digest_syncs"] + last["n_gather_syncs"] <= 2


def test_resume_after_in_place_update_restores_the_commit():
    """Tensors change in place after a save; resuming the session on the
    same service installs fresh per-session state first, so checkout has
    no previous graph to take live bytes from and reads every pod from
    the store.  The next save is incremental: pods reused, <= 2 fetches."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(16)
    svc = port_svc()
    svc.open_session("a")
    st = _state(rng, rows=256)
    tip = svc.save_session("a", st)
    committed = from_torch(st)
    st["params"]["emb"][:3] += 1.0           # in place, not saved
    st["opt"]["mu"][5] = 2.0
    restored = svc.resume_session("a")
    assert tree_equal(from_torch(restored), committed)
    cs = svc.sessions["a"].last_checkout_stats
    assert cs.time_id == tip
    assert cs.n_pods_fetched == cs.n_pods > 0 and cs.n_pods_live == 0
    assert cs.n_leaves_reused == 0 and cs.n_dirty_chunks == 0
    assert restored["params"]["emb"] is not st["params"]["emb"]
    restored["params"]["emb"][7] += 0.5
    f0 = ops.fetch_count
    svc.save_session("a", restored)
    s = svc.pool[svc.sessions["a"].slot].save_stats[-1]
    assert s["n_pods_reused"] > 0 and s["n_dirty_chunks"] >= 1
    assert ops.fetch_count - f0 == \
        s["n_digest_syncs"] + s["n_gather_syncs"] <= 2


def test_interleaved_sessions_keep_incremental_pipelines():
    """More sessions than pool slots, saved round-robin: each stays
    correct and incremental, and every swapped-out session keeps its own
    detector with its device-resident digest table."""
    rng = np.random.default_rng(4)
    svc = port_svc(pool_size=1)
    states = {}
    for s in range(3):
        svc.open_session(f"s{s}")
        states[f"s{s}"] = _state(rng, rows=256)
    for rnd in range(3):
        for sid, st in states.items():
            st["params"]["emb"][rnd:rnd + 2] += 0.1
            tid = svc.save_session(sid, st)
            assert tree_equal(from_torch(svc.pool[0].load(time_id=tid)),
                              from_torch(st))
    ck = svc.pool[0]
    last = ck.save_stats[-1]
    tip_bytes = sum(svc.store.pod_nbytes(d)
                    for d in ck.versions.pod_digests_of(last["time_id"]))
    assert last["bytes_written"] < tip_bytes / 2
    tables = set()
    for sid, ctx in svc.sessions.items():
        det = ck.detector if svc._bound[0] == sid else ctx.detector
        assert det._dev_table is not None, sid
        tables.add(id(det._dev_table))
    assert len(tables) == 3


def test_evict_matches_mark_and_sweep_oracle():
    rng = np.random.default_rng(5)
    svc = port_svc()
    for sid in ("keep", "die"):
        svc.open_session(sid)
        st = _state(rng, rows=128)
        for rnd in range(3):
            st["params"]["emb"][rnd] += 1.0
            svc.save_session(sid, st)
    ck0 = svc.pool[0]
    ck0.versions.sync()
    branch = SESSION_NS + "die"
    tip = ck0.versions.branches[branch]
    ck0.versions.delete_branch(branch)
    extra = tuple(ck._head for ck in svc.pool
                  if ck._head is not None and ck._head != tip)
    oracle = mark_and_sweep(svc.store, ck0.versions, extra_roots=extra,
                            dry_run=True)
    ck0.versions.create_branch(branch, at=tip, switch=False)
    dry = ck0.evict_branch(branch, dry_run=True)
    real = svc.evict_session("die")
    assert oracle.n_commits_deleted == 3
    assert set(real.deleted_pod_digests) == set(oracle.deleted_pod_digests)
    assert real.bytes_reclaimed == oracle.bytes_reclaimed > 0
    assert real.n_commits_deleted == oracle.n_commits_deleted
    assert dry.bytes_reclaimed == real.bytes_reclaimed
    left = mark_and_sweep(svc.store, ck0.versions, dry_run=True,
                          extra_roots=tuple(ck._head for ck in svc.pool
                                            if ck._head is not None))
    assert left.n_pods_deleted == 0 and left.n_commits_deleted == 0
    assert svc.pool[0].load(time_id=svc.sessions["keep"].head) is not None
    assert not ck0.refcounts.rebuild()


def test_evicting_fork_keeps_shared_history():
    rng = np.random.default_rng(6)
    svc = port_svc()
    svc.open_session("root")
    st = _state(rng, rows=128)
    want = from_torch(st)
    root_tip = svc.save_session("root", st)
    svc.open_session("twin", from_ref=SESSION_NS + "root")
    stats = svc.evict_session("twin")
    assert stats.n_commits_deleted == 0 and stats.bytes_reclaimed == 0
    svc.open_session("fork", from_ref=SESSION_NS + "root")
    fs = svc.resume_session("fork")
    fs["params"]["emb"][:2] += 2.0
    svc.save_session("fork", fs)
    stats = svc.evict_session("fork")
    assert stats.n_commits_deleted == 1 and stats.bytes_reclaimed > 0
    assert tree_equal(from_torch(svc.pool[0].load(time_id=root_tip)), want)


def test_evict_idle():
    rng = np.random.default_rng(7)
    svc = port_svc()
    for sid in ("old", "fresh"):
        svc.open_session(sid)
        svc.save_session(sid, _state(rng))
    svc.sessions["old"].last_used = 100.0
    svc.sessions["fresh"].last_used = 1000.0
    assert svc.evict_idle(50.0, now=1001.0) == ["old"]
    assert svc.session_ids() == ["fresh"]


def test_crash_mid_evict_fsck_rebuilds_refcounts():
    rng = np.random.default_rng(10)
    fstore = FaultyStore(MemoryStore())
    svc = port_svc(fstore, pool_size=1)
    keep_state = _state(rng, rows=128)
    keep_want = from_torch(keep_state)
    svc.open_session("keep")
    keep_tip = svc.save_session("keep", keep_state)
    svc.open_session("die")
    st = _state(rng, rows=128)
    for rnd in range(2):
        st["params"]["emb"][rnd] += 1.0
        svc.save_session("die", st)
    fstore.clear()
    fstore.arm("delete_manifest", "crash-before")
    with pytest.raises(InjectedCrash):
        svc.evict_session("die")
    fstore.clear()
    svc2 = port_svc(fstore, pool_size=1, fsck_on_open="deep")
    ck0 = svc2.pool[0]
    assert ck0.last_fsck.refcounts_rebuilt
    assert not ck0.refcounts.rebuild()
    assert ck0.versions.branches_under(SESSION_NS) == \
        {SESSION_NS + "keep": keep_tip}
    assert tree_equal(from_torch(svc2.resume_session("keep")), keep_want)
    swept = ck0.gc(full=True)
    assert swept.n_commits_deleted == 2 and swept.bytes_reclaimed > 0
    left = ck0.gc(full=True, dry_run=True)
    assert left.n_pods_deleted == 0 and left.n_commits_deleted == 0


def test_shared_tids_never_collide():
    rng = np.random.default_rng(15)
    store = MemoryStore()
    cks = [Chipmink(store, chunk_bytes=1 << 10, device="cpu",
                    shared_tids=True, refcounts=True) for _ in range(2)]
    states = [_state(rng, rows=64) for _ in cks]
    tids = []
    for rnd in range(3):
        for i, ck in enumerate(cks):
            states[i]["step"] = rnd
            tids.append(ck.save(states[i], branch=f"{SESSION_NS}w{i}"))
    assert len(set(tids)) == len(tids)
    assert sorted(tids) == tids
    assert set(store.list_time_ids()) == set(tids)


# ---------------------------------------------------------------------------
# a FileStore written by either package's service, resumed in the other's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_file_store_sessions_resume_across_packages(writer):
    rng = np.random.default_rng(17)
    hosts = {sid: base_state(rng, rows=128) for sid in ("a", "b")}
    with tempfile.TemporaryDirectory() as root:
        if writer == "reference":
            w, conv = ref_svc(RefFileStore(root)), jax_copy
        else:
            w, conv = port_svc(FileStore(root)), to_torch
        tips = {}
        for sid, st in hosts.items():
            w.open_session(sid)
            w.save_session(sid, conv(st))
            st["params"]["emb"][sid == "a"] += np.float32(0.5)
            tips[sid] = w.save_session(sid, conv(st))
        assert w.close() == []
        if writer == "reference":
            r, back = port_svc(FileStore(root)), from_torch
        else:
            r, back = ref_svc(RefFileStore(root)), as_np
        for sid, st in hosts.items():
            assert tree_equal(back(r.resume_session(sid)), st)
            assert r.sessions[sid].head == tips[sid]
        # the resumed session's next save is incremental, in the reader
        st = hosts["a"]
        st["params"]["emb"][3] += np.float32(0.25)
        conv = to_torch if writer == "reference" else jax_copy
        tid = r.save_session("a", conv(st))
        s = r.pool[r.sessions["a"].slot].save_stats[-1]
        assert s["n_pods_reused"] > 0
        assert tree_equal(back(r.pool[0].load(time_id=tid)), st)
        assert r.close() == []
