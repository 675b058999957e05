"""Port multi-writer leases vs the reference package, blob for blob.

Every lease scenario of the reference's tests runs twice, once over each
package's `LeaseManager` / `FaultyStore` / `MemoryStore`, with the same
fake clock and owner: the results (leases as dicts, raised exception
types, counters) and the lease meta blob's bytes after every step must be
equal.  `Chipmink(multi_writer=True)` sequences run in lockstep with the
reference's, their lease managers on a shared fake clock: stores,
TimeID counters, lease blobs, `GCStats` and `fsck` reports equal.  The
lease crash matrix kills each package's holder at every protocol step
and reboots both; the repaired stores must be byte-identical.  Two port
writers and a collector on threads check that TimeIDs stay unique and no
commit is lost.  Tolerance zero.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.version import fsck as ref_fsck
from repro.version import mark_and_sweep as ref_mark_and_sweep
from repro_torch.version import CommitDAG, RefsCASError
from repro_torch.version import fsck as port_fsck
from repro_torch.version import mark_and_sweep as port_mark_and_sweep

from test_torch_checkpoint import to_jax, to_torch
from test_torch_version import assert_stores_equal, from_torch, results

#: seconds a test waits on a thread before failing instead of hanging
JOIN_S = 30.0
PKGS = {"ref": R, "port": P}


class FakeClock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def norm(x):
    """A result in a package-free form: leases and reports as dicts,
    sets sorted."""
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, (set, frozenset)):
        return sorted(x)
    if isinstance(x, tuple):
        return tuple(norm(v) for v in x)
    return x


class Log:
    """What a scenario observed: results, exception types and the lease
    blob after each step."""

    def __init__(self, store):
        self.store = store
        self.seen = []

    def __call__(self, value=None):
        self.seen.append((norm(value), self.store.get_meta("leases")))
        return value

    def raises(self, exc, fn, *args):
        with pytest.raises(exc):
            fn(*args)
        self.seen.append((exc.__name__, self.store.get_meta("leases")))


# ---------------------------------------------------------------------------
# lease mechanics: one scenario per reference test, run over both packages
# ---------------------------------------------------------------------------

def writers_shared_fenced_and_expiring(pkg, log, store, clk):
    a = pkg.LeaseManager(store, owner="a", ttl_s=10, clock=clk)
    b = pkg.LeaseManager(store, owner="b", ttl_s=10, clock=clk)
    la = log(a.acquire_writer())
    lb = log(b.acquire_writer())
    assert lb.fence > la.fence
    a.check(la)
    b.check(lb)
    log(sorted(a.live_leases()))
    clk.advance(8)
    log(a.renew(la))
    clk.advance(3)
    log.raises(pkg.LeaseLost, b.check, lb)
    log.raises(pkg.LeaseLost, b.renew, lb)
    log(a.reap_expired())
    a.release(la)
    a.release(la)
    log(a.live_leases())


def gc_lease_exclusive_takeover_and_fencing(pkg, log, store, clk):
    a = pkg.LeaseManager(store, owner="a", ttl_s=5, clock=clk)
    b = pkg.LeaseManager(store, owner="b", ttl_s=5, clock=clk)
    ga = log(a.acquire_gc())
    log.raises(pkg.LeaseHeld, b.acquire_gc)
    clk.advance(6)
    gb = log(b.acquire_gc())
    log(b.n_takeovers)
    assert gb.fence > ga.fence
    log.raises(pkg.LeaseLost, a.renew, ga)
    log.raises(pkg.LeaseLost, a.begin_sweep, ga)


def intents_pin_and_sweep_fence_blocks_registration(pkg, log, store, clk):
    w = pkg.LeaseManager(store, owner="w", ttl_s=50, clock=clk)
    g = pkg.LeaseManager(store, owner="g", ttl_s=50, clock=clk)
    lw = w.acquire_writer()
    w.set_intent(lw, time_ids=[7], digests=["aa", "bb"])
    log(w.live_intents())
    lg = g.acquire_gc()
    log(g.begin_sweep(lg))
    log(g.gc_sweeping())
    done = []

    def register():
        w.set_intent(lw, time_ids=[8], digests=["cc"])
        done.append(True)

    th = threading.Thread(target=register, daemon=True)
    th.start()
    time.sleep(0.1)
    assert not done                    # parked behind the live sweep
    g.end_sweep(lg)
    th.join(timeout=JOIN_S)
    assert done and w.n_sweep_waits > 0
    log(w.live_intents())
    g.release(lg)
    log(g.gc_sweeping())


def dead_sweeper_reaped_inline_by_set_intent(pkg, log, store, clk):
    w = pkg.LeaseManager(store, owner="w", ttl_s=100, clock=clk)
    g = pkg.LeaseManager(store, owner="g", ttl_s=5, clock=clk)
    lw = w.acquire_writer()
    lg = g.acquire_gc()
    g.begin_sweep(lg)
    clk.advance(6)
    w.set_intent(lw, time_ids=[1], digests=["aa"])
    log((w.n_phase_resets, w.gc_sweeping(), w.live_leases()))


def torn_lease_blob_is_soft_state(pkg, log, store, clk):
    m = pkg.LeaseManager(store, owner="m", ttl_s=5, clock=clk)
    lease = m.acquire_writer()
    store.put_meta("leases", b"\xc1garbage")
    log.raises(pkg.LeaseLost, m.check, lease)
    l2 = log(m.acquire_writer())
    m.check(l2)


def store_level_lease_faults_are_isolated(pkg, log, store, clk):
    fs = pkg.FaultyStore(store)
    m = pkg.LeaseManager(fs, owner="m", clock=clk)
    lease = log(m.acquire_writer())
    clk.advance(1)
    fs.arm("cas_lease", "crash-before")
    log.raises(pkg.InjectedCrash, m.renew, lease)
    fs.clear()
    m.check(lease)                     # the CAS never landed; still held
    log(m.renew(lease))


SCENARIOS = [writers_shared_fenced_and_expiring,
             gc_lease_exclusive_takeover_and_fencing,
             intents_pin_and_sweep_fence_blocks_registration,
             dead_sweeper_reaped_inline_by_set_intent,
             torn_lease_blob_is_soft_state,
             store_level_lease_faults_are_isolated]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_lease_mechanics_match_reference(scenario):
    seen = {}
    for name, pkg in PKGS.items():
        store = pkg.MemoryStore()
        log = Log(store)
        scenario(pkg, log, store, FakeClock())
        seen[name] = log.seen
    assert seen["ref"] == seen["port"]
    assert seen["port"]


# ---------------------------------------------------------------------------
# Chipmink(multi_writer=True) in lockstep with the reference
# ---------------------------------------------------------------------------

def head(ck):
    """A `Chipmink`'s head: the port keeps it in its lineage, the
    reference as ``_head``."""
    return ck.lineage.head if hasattr(ck, "lineage") else ck._head


def _small_state(fill: float):
    return {"w": np.full((32, 8), np.float32(fill)),
            "b": np.arange(16, dtype=np.float32) + np.float32(fill),
            "step": int(fill)}


def _assert_state(loaded, fill: float):
    got = from_torch(loaded) if any(isinstance(v, torch.Tensor)
                                    for v in loaded.values()) \
        else {k: np.asarray(v) for k, v in loaded.items()}
    want = _small_state(fill)
    assert int(got["step"]) == want["step"]
    for k in ("w", "b"):
        assert np.array_equal(got[k], want[k]), k


CONV = {"ref": to_jax, "port": to_torch}


class MW:
    """One multi-writer instance per package over its own store, lease
    managers on a shared fake clock with one owner name: `call` applies a
    method to both and returns both results."""

    def __init__(self, stores, clk, owner="w", **kw):
        self.ck = {}
        for name, pkg in PKGS.items():
            extra = {} if name == "ref" else {"device": "cpu"}
            ck = pkg.Chipmink(stores[name], multi_writer=True,
                              lease_heartbeat=False, chunk_bytes=1 << 10,
                              **extra, **kw)
            ck.leases = pkg.LeaseManager(stores[name], owner=owner,
                                         ttl_s=10, clock=clk)
            self.ck[name] = ck

    def save(self, fill):
        tids = {n: ck.save(CONV[n](_small_state(fill)))
                for n, ck in self.ck.items()}
        assert tids["ref"] == tids["port"]
        return tids["port"]

    def call(self, method, *args, **kw):
        return {n: getattr(ck, method)(*args, **kw)
                for n, ck in self.ck.items()}

    def close(self):
        assert self.call("close") == {"ref": [], "port": []}


def _stores():
    return {"ref": R.MemoryStore(), "port": P.MemoryStore()}


def test_gc_pins_intent_held_pods_like_reference():
    stores, clk = _stores(), FakeClock()
    mw = MW(stores, clk)
    mw.save(1.0)
    peers = {}
    for name, pkg in PKGS.items():
        peer = pkg.LeaseManager(stores[name], owner="peer", ttl_s=60,
                                clock=clk)
        lp = peer.acquire_writer()
        stores[name].put_pod("feedface", b"x" * 64)
        peer.set_intent(lp, time_ids=[999], digests=["feedface"])
        peers[name] = (peer, lp)
    dry = mw.call("gc", dry_run=True)
    real = mw.call("gc")
    assert results(dry["ref"]) == results(dry["port"])
    assert results(real["ref"]) == results(real["port"])
    assert real["port"].n_pods_pinned == 1 and real["port"].gc_fence
    assert stores["port"].has_pod("feedface")
    assert_stores_equal(stores["ref"], stores["port"])
    for peer, lp in peers.values():
        peer.clear_intent(lp)
    real = mw.call("gc")
    assert results(real["ref"]) == results(real["port"])
    assert not stores["port"].has_pod("feedface")
    assert_stores_equal(stores["ref"], stores["port"])
    mw.close()
    assert_stores_equal(stores["ref"], stores["port"])


def test_time_ids_unique_across_instances_like_reference():
    stores, clk = _stores(), FakeClock()
    a = MW(stores, clk, owner="a")
    b = MW(stores, clk, owner="b", fsck_on_open=False)
    tids = [a.save(1.0), b.save(2.0), a.save(3.0), b.save(4.0)]
    assert len(set(tids)) == 4
    assert sorted(tids) == stores["port"].list_time_ids()
    assert_stores_equal(stores["ref"], stores["port"])
    a.close()
    b.close()
    assert_stores_equal(stores["ref"], stores["port"])
    assert P.LeaseManager(stores["port"]).live_leases() == []


def test_lease_expiry_race_aborts_before_refs_cas_like_reference():
    stores, clk = _stores(), FakeClock()
    mw = MW(stores, clk)
    t1 = mw.save(1.0)
    for name, ck in mw.ck.items():
        fired = []

        def hook(op, when, ck=ck, fired=fired):
            if op == "set_intent" and when == "after" and not fired:
                fired.append(True)
                lid = ck._writer_lease.lease_id
                ck.leases._mutate(lambda blob: blob["leases"].pop(lid, None))

        ck.leases._op_hook = hook
        with pytest.raises(PKGS[name].LeaseLost):
            ck.save(CONV[name](_small_state(2.0)))
        assert fired and ck.versions.head_commit() == t1
        ck.leases._op_hook = None
    assert_stores_equal(stores["ref"], stores["port"])
    t3 = mw.save(3.0)
    assert mw.ck["port"].versions.head_commit() == t3
    _assert_state(mw.ck["port"].load(time_id=t3), 3.0)
    assert_stores_equal(stores["ref"], stores["port"])
    mw.close()


def test_aliased_pod_swept_before_intent_is_rewritten_like_reference():
    stores, clk = _stores(), FakeClock()
    mw = MW(stores, clk)
    t1 = mw.save(1.0)
    mw.save(2.0)
    for store in stores.values():
        live = {m["d"] for m in store.get_manifest(t1 + 1)["pods"].values()}
        doomed = [m["d"] for m in store.get_manifest(t1)["pods"].values()
                  if m["d"] not in live]
        assert doomed
        for d in doomed:
            store.delete_pod(d)
        store.delete_manifest(t1)
    t3 = mw.save(1.0)
    rewrites = {n: ck.save_stats[-1]["n_alias_rewrites"]
                for n, ck in mw.ck.items()}
    assert rewrites["ref"] == rewrites["port"] >= 1
    _assert_state(mw.ck["port"].load(time_id=t3), 1.0)
    assert_stores_equal(stores["ref"], stores["port"])
    mw.close()


def test_commit_racing_the_sweep_fence_forces_remark_like_reference():
    got = {}
    for name, pkg in PKGS.items():
        store = pkg.MemoryStore()
        extra = {} if name == "ref" else {"device": "cpu"}
        ck = pkg.Chipmink(store=store, multi_writer=True,
                          lease_heartbeat=False, **extra)
        ck.save(CONV[name](_small_state(1.0)))
        peer = pkg.Chipmink(store=store, multi_writer=True,
                            lease_heartbeat=False, fsck_on_open=False,
                            **extra)
        peer.checkout("main")
        peer.branch("peer")
        committed = []

        def commit_now(peer=peer, committed=committed, name=name):
            if not committed:
                committed.append(peer.save(CONV[name](_small_state(7.0))))
                peer.wait()

        sweep = ref_mark_and_sweep if name == "ref" else port_mark_and_sweep
        stats = sweep(store, ck.versions, extra_roots=(head(ck),),
                      leases=ck.leases, _after_mark=commit_now)
        assert stats.n_mark_restarts >= 1
        _assert_state(peer.load(time_id=committed[0]), 7.0)
        assert not ck.leases.gc_sweeping()
        got[name] = results(stats)
        assert peer.close() == [] and ck.close() == []
    for r in got.values():
        r.pop("gc_fence")             # the fence counts real-clock leases
    assert got["ref"] == got["port"]


def test_fsck_reaps_dead_writers_and_honors_live_ones_like_reference():
    stores, clk = _stores(), FakeClock()
    mw = MW(stores, clk)
    mw.save(1.0)
    mw.save(2.0)
    reports = {}
    for name, pkg in PKGS.items():
        store = stores[name]
        live = pkg.LeaseManager(store, owner="live", ttl_s=100, clock=clk)
        dead = pkg.LeaseManager(store, owner="dead", ttl_s=5, clock=clk)
        lv, ld = live.acquire_writer(), dead.acquire_writer()
        store.put_pod("ab" * 16, b"y" * 32)         # live peer mid-save
        live.set_intent(lv, time_ids=[50], digests=["ab" * 16])
        store.put_pod("cd" * 16, b"z" * 32)         # dead peer's debris
        dead.set_intent(ld, time_ids=[51], digests=["cd" * 16])
        gc = pkg.LeaseManager(store, owner="gc", ttl_s=5, clock=clk)
        gc.begin_sweep(gc.acquire_gc())             # a sweeper that died
        reports[name] = []
    clk.advance(10)
    for name in PKGS:
        fsck = ref_fsck if name == "ref" else port_fsck
        mgr = PKGS[name].LeaseManager(stores[name], owner="fsck", clock=clk)
        for kw in (dict(repair=False), dict(sweep_orphans=True)):
            reports[name].append(results(fsck(stores[name], leases=mgr,
                                              **kw)))
    assert reports["ref"] == reports["port"]
    rep = reports["port"][-1]
    assert rep["n_leases_live"] == 1 and rep["gc_phase_reset"]
    assert len(rep["leases_reaped"]) == 3        # writer 1, dead, gc
    assert stores["port"].has_pod("ab" * 16)
    assert not stores["port"].has_pod("cd" * 16)
    assert_stores_equal(stores["ref"], stores["port"])


# ---------------------------------------------------------------------------
# real threads: heartbeat, two writers and a collector
# ---------------------------------------------------------------------------

def test_heartbeat_renewal_loss_then_reacquire():
    store = P.MemoryStore()
    ck = P.Chipmink(store=store, device="cpu", multi_writer=True,
                    lease_ttl_s=0.15)
    try:
        t1 = ck.save(to_torch(_small_state(1.0)))
        lease1, hb = ck._writer_lease, ck._heartbeat
        assert hb is not None and not hb.lost
        peer = P.LeaseManager(store, owner="peer")
        peer._mutate(lambda blob: blob["leases"].pop(lease1.lease_id, None))
        deadline = time.monotonic() + JOIN_S
        while not hb.lost and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hb.lost
        t2 = ck.save(to_torch(_small_state(2.0)))
        assert ck._writer_lease.fence > lease1.fence
        assert ck.versions.head_commit() == t2
        _assert_state(ck.load(time_id=t1), 1.0)
    finally:
        assert ck.close() == []
    assert ck._heartbeat is None
    assert P.LeaseManager(store).live_leases() == []


def test_two_writer_threads_and_a_collector_lose_nothing(tmp_path):
    """Two multi-writer instances on one FileStore save from two threads
    on two branches while a third runs gc(): TimeIDs are unique and every
    acknowledged commit loads bit-exact afterwards."""
    root = str(tmp_path)
    writers = [P.Chipmink(P.FileStore(root), device="cpu", multi_writer=True,
                          lease_heartbeat=False, chunk_bytes=1 << 10,
                          fsck_on_open=i == 0) for i in range(2)]
    collector = P.Chipmink(P.FileStore(root), device="cpu", multi_writer=True,
                           lease_heartbeat=False, fsck_on_open=False)
    acked = {}
    errors = []
    lock = threading.Lock()
    base = writers[0].save(to_torch(_small_state(0.0)))
    acked[base] = 0.0
    for i, ck in enumerate(writers):
        ck.versions.sync()
        ck.lineage.head = base
        ck.branch(f"w{i}")

    def write(i, ck):
        try:
            for r in range(4):
                fill = float(10 * (i + 1) + r)
                tid = ck.save(to_torch(_small_state(fill)))
                with lock:
                    acked[tid] = fill
        except BaseException as e:     # surfaced below
            errors.append(e)

    def collect():
        try:
            for _ in range(3):
                collector.gc()
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=write, args=(i, ck), daemon=True)
               for i, ck in enumerate(writers)]
    threads.append(threading.Thread(target=collect, daemon=True))
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=JOIN_S)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert len(acked) == 9                          # unique TimeIDs
    fresh = P.Chipmink(P.FileStore(root), device="cpu", fsck_on_open=False)
    for tid, fill in acked.items():
        _assert_state(fresh.load(time_id=tid), fill)
    refs = CommitDAG(P.FileStore(root)).branches
    assert refs["w0"] == max(t for t, f in acked.items() if 10 <= f < 20)
    assert refs["w1"] == max(t for t, f in acked.items() if f >= 20)
    for ck in writers + [collector]:
        assert ck.close() == []
    assert port_fsck(P.FileStore(root), repair=False, deep=True).clean


# ---------------------------------------------------------------------------
# the lease-protocol crash matrix, both packages
# ---------------------------------------------------------------------------

TTL = 0.3


def _open(name, root, hook=None, fsck_on_open=False):
    pkg = PKGS[name]
    extra = {} if name == "ref" else {"device": "cpu"}
    ck = pkg.Chipmink(store=pkg.FileStore(root), multi_writer=True,
                      lease_heartbeat=False, lease_ttl_s=TTL,
                      fsck_on_open=fsck_on_open, **extra)
    ck.leases.owner = "holder"
    if hook is not None:
        ck.leases._op_hook = hook
    return ck


def _crash(name, root, op, when):
    """Two commits, then a holder killed at (op, when).  Returns the
    (TimeID, fill) pairs that must survive and the head refs must name."""
    pkg = PKGS[name]
    conv = CONV[name]
    ck1 = _open(name, root)
    tids, fills = [], []
    for fill in (1.0, 2.0):
        tids.append(ck1.save(conv(_small_state(fill))))
        fills.append(fill)
    assert ck1.close() == []
    inj = pkg.LeaseFaultInjector()
    ck2 = _open(name, root, hook=inj)
    if op in ("acquire", "set_intent", "clear_intent"):
        inj.arm(op, when)
        with pytest.raises(pkg.InjectedCrash):
            ck2.save(conv(_small_state(3.0)))
        if op == "clear_intent":          # the refs CAS had landed
            tids.append(tids[-1] + 1)
            fills.append(3.0)
    elif op == "renew":
        tids.append(ck2.save(conv(_small_state(3.0))))
        fills.append(3.0)
        inj.arm(op, when)
        with pytest.raises(pkg.InjectedCrash):
            ck2.leases.renew(ck2._writer_lease)
    else:                                 # begin_sweep / end_sweep
        tids.append(ck2.save(conv(_small_state(3.0))))
        fills.append(3.0)
        sweeper = pkg.LeaseManager(pkg.FileStore(root), owner="sweeper",
                                   ttl_s=TTL, op_hook=inj)
        lg = sweeper.acquire_gc()
        if op == "end_sweep":
            sweeper.begin_sweep(lg)
        inj.arm(op, when)
        with pytest.raises(pkg.InjectedCrash):
            getattr(sweeper, op)(lg)
    assert inj.n_fired == 1
    return tids, fills


def _reboot(name, root, op, when, tids, fills):
    ck3 = _open(name, root, fsck_on_open=True)
    rep = ck3.last_fsck
    if (op, when) != ("acquire", "before"):
        assert rep.leases_reaped
    assert ck3.leases.live_leases() == []
    assert rep.gc_phase_reset == ((op, when) in {("begin_sweep", "after"),
                                                 ("end_sweep", "before")})
    assert ck3.versions.head_commit() == tids[-1]
    for tid, fill in zip(tids, fills):
        _assert_state(ck3.load(time_id=tid), fill)
    t = ck3.save(CONV[name](_small_state(9.0)))
    gc_stats = ck3.gc()
    assert gc_stats.gc_fence is not None
    _assert_state(ck3.load(time_id=t), 9.0)
    for tid, fill in zip(tids, fills):
        _assert_state(ck3.load(time_id=tid), fill)
    assert ck3.fsck().leases_reaped == []
    assert ck3.close() == []
    return results(rep), results(gc_stats)


@pytest.mark.parametrize("op,when", P.lease_matrix_points(),
                         ids=lambda v: str(v))
def test_lease_crash_matrix_matches_reference(tmp_path, op, when):
    """Kill each package's holder on either side of every lease protocol
    CAS, then reboot both after the TTL: every committed state loads
    bit-exact, refs name a complete commit, the dead holder's debris is
    reaped, saves and GC still work, and the two stores, fsck reports
    and GCStats are equal."""
    assert P.lease_matrix_points() == R.lease_matrix_points()
    roots = {n: str(tmp_path / n) for n in PKGS}
    crashed = {n: _crash(n, roots[n], op, when) for n in PKGS}
    assert crashed["ref"] == crashed["port"]
    time.sleep(TTL + 0.1)
    out = {n: _reboot(n, roots[n], op, when, *crashed[n]) for n in PKGS}
    for n in PKGS:
        out[n][1].pop("gc_fence")        # counts the real-clock leases
    assert out["ref"] == out["port"]
    assert_stores_equal(R.FileStore(roots["ref"]), P.FileStore(roots["port"]),
                        meta_keys=("refs", "tid_counter"))


# ---------------------------------------------------------------------------
# refs CAS budget and backoff
# ---------------------------------------------------------------------------

def test_refs_cas_budget_and_backoff_configurable(monkeypatch):
    store = P.MemoryStore()
    CommitDAG(store).record(1, None)
    dag = CommitDAG(store, max_cas_retries=3,
                    cas_backoff=P.RetryPolicy(backoff_s=0.01, multiplier=2.0,
                                              jitter=0.0))
    monkeypatch.setattr(store, "compare_and_put_meta",
                        lambda key, old, new: False)
    sleeps = []
    monkeypatch.setattr("repro_torch.version.commit_graph.time.sleep",
                        sleeps.append)
    with pytest.raises(RefsCASError, match="max_cas_retries"):
        dag.record(2, 1)
    assert dag.n_cas_races == 3
    assert sleeps == [0.01, 0.02]


def test_chipmink_refs_cas_options_reach_the_dag():
    ck = P.Chipmink(P.MemoryStore(), device="cpu", max_refs_cas_retries=5,
                    refs_cas_backoff=P.RetryPolicy(backoff_s=0.5))
    assert ck.versions.max_cas_retries == 5
    assert ck.versions.cas_backoff.backoff_s == 0.5
