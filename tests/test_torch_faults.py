"""Port fault injection and crash recovery vs the reference package.

The crash matrices of the reference's tests (`crash_matrix_points`,
`delta_matrix_points`) run over both packages: the same history is
killed at the same (point, flavor) by each package's `FaultyStore`, each
store is rebooted with a deep fsck, and the two repaired stores, their
fsck reports and every restored state must be identical.  Tolerance
zero.  As in the reference, the default run covers every (point, flavor)
once and only the full sweep over later calls is ``slow``.
"""
import os

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.version import fsck as ref_fsck
from repro_torch.version import fsck as port_fsck

from proptest import base_state, snapshot_state, sparse_mutate_state, \
    tree_equal
from test_torch_checkpoint import convert, to_jax, to_torch
from test_torch_version import assert_stores_equal, from_torch, results

PKGS = {"ref": R, "port": P}
FSCK = {"ref": ref_fsck, "port": port_fsck}


def _conv(name, state):
    """A numpy state as the package's input (fresh arrays, aliases kept)."""
    state = convert(state, np.copy)
    return to_jax(state) if name == "ref" else to_torch(state)


def _np(name, loaded):
    return convert(loaded, np.asarray) if name == "ref" else from_torch(loaded)


def _ck(name, store, **kw):
    pkg = PKGS[name]
    extra = {} if name == "ref" else {"device": "cpu"}
    return pkg.Chipmink(store=store, **extra, **kw)


def _no_debris(root):
    bad = []
    for dirpath, _, fnames in os.walk(root):
        bad += [os.path.join(dirpath, f) for f in fnames
                if f.endswith(".tmp") or f.endswith(".lock")]
    return bad


def _mk_state(rng, rows=256):
    return {
        "params": {"emb": rng.standard_normal((rows, 8)).astype(np.float32),
                   "w": rng.standard_normal((16, 16)).astype(np.float32)},
        "opt": {"mu": np.zeros((rows, 8), np.float32)},
        "step": 0,
    }


def _mutate(state, i):
    state["params"]["w"] = state["params"]["w"] + np.float32(1.0)
    state["opt"]["mu"] = state["opt"]["mu"] + np.float32(0.5)
    state["step"] = i
    return state


def _expected_head(point, flavor, t_last, t_attempt):
    """Once the refs CAS ran (crash-after) or tore, the attempt is the
    committed truth; at every earlier death refs name the previous
    commit."""
    if point == "cas_meta" and flavor in ("torn", "crash-after"):
        return t_attempt
    return t_last


def _run_crash_case(name, root, point, flavor, *, mk_ck, setup, n_setup_saves,
                    skip=0, seed=0, max_depth=None):
    """Seed a history of `n_setup_saves` commits, kill the next save at
    (point, flavor), reboot with a deep fsck and check the contract:
    refs name a complete commit bit-identical to the pre-crash oracle, no
    debris, and the killed save lands when re-run.  Returns None when the
    point is not called by that save, else (fsck report, head)."""
    pkg = PKGS[name]
    fs = pkg.FaultyStore(pkg.FileStore(root))
    ck = mk_ck(name, fs, fsck_on_open=False)
    s, step = setup(seed)
    oracle, tids = {}, []
    for i in range(n_setup_saves):
        step(s, i)
        tid = ck.save(_conv(name, s))
        tids.append(tid)
        oracle[tid] = snapshot_state(s)
    step(s, n_setup_saves)
    t_attempt = tids[-1] + 1
    oracle[t_attempt] = snapshot_state(s)
    fs.clear()
    fault = fs.arm(point, flavor, skip=skip)
    try:
        ck.save(_conv(name, s))
        crashed = False
    except pkg.InjectedCrash:
        crashed = True
    if fault.n_fired == 0:
        assert not crashed
        return None
    assert crashed, f"{point}/{flavor} fired but the save survived"

    ck2 = mk_ck(name, pkg.FileStore(root), fsck_on_open="deep")
    boot = results(ck2.last_fsck)
    head = ck2.versions.head_commit()
    assert head == _expected_head(point, flavor, tids[-1], t_attempt)
    rep = FSCK[name](ck2.store, repair=False, deep=True)
    assert head not in rep.incomplete
    assert tree_equal(_np(name, ck2.load(time_id=head)), oracle[head])
    assert not _no_debris(root)
    if max_depth is not None:
        for d in ck2.store.list_pods():
            assert ck2.store.pod_chain_depth(d) <= max_depth
    t_redo = ck2.save(_conv(name, oracle[t_attempt]))
    assert tree_equal(_np(name, ck2.load(time_id=t_redo)), oracle[t_attempt])
    assert FSCK[name](ck2.store, repair=False, deep=True).clean
    return boot, head


def _both(tmp_path, tag, point, flavor, **kw):
    """The crash case in each package, in its own directory: both fire or
    neither, and the results and repaired stores are identical."""
    roots = {n: str(tmp_path / f"{tag}-{n}") for n in PKGS}
    for r in roots.values():
        os.makedirs(r)
    out = {n: _run_crash_case(n, roots[n], point, flavor, **kw)
           for n in PKGS}
    assert out["ref"] == out["port"]
    if out["port"] is not None:
        assert_stores_equal(R.FileStore(roots["ref"]),
                            P.FileStore(roots["port"]))
    return out["port"] is not None


def _plain_setup(seed):
    return _mk_state(np.random.default_rng(seed)), _mutate


def test_matrix_points_match_reference():
    assert P.crash_matrix_points() == R.crash_matrix_points()
    assert P.delta_matrix_points() == R.delta_matrix_points()
    assert P.lease_matrix_points() == R.lease_matrix_points()


@pytest.mark.parametrize("point,flavor", P.crash_matrix_points(),
                         ids=lambda v: str(v))
def test_crash_matrix_matches_reference(tmp_path, point, flavor):
    assert _both(tmp_path, "c", point, flavor, mk_ck=_ck,
                 setup=_plain_setup, n_setup_saves=2)


@pytest.mark.slow
@pytest.mark.parametrize("point,flavor", P.crash_matrix_points(),
                         ids=lambda v: str(v))
def test_crash_matrix_full_sweep_matches_reference(tmp_path, point, flavor):
    """Kill at later calls of each point too, across several histories;
    a (skip, seed) cell whose point is not called that often does not
    fire in either package."""
    n_ran = 0
    for seed in range(2):
        for skip in (0, 1):
            n_ran += _both(tmp_path, f"s{seed}k{skip}", point, flavor,
                           mk_ck=_ck, setup=_plain_setup,
                           n_setup_saves=3, skip=skip, seed=seed)
    assert n_ran >= 2


# ---------------------------------------------------------------------------
# the delta edition
# ---------------------------------------------------------------------------

def _delta_ck(name, store, **kw):
    """Sparse saves publish chunk deltas (one pod per leaf set, chain
    depth capped at 2, so both the delta publish and the depth-cap
    whole-pod fallback are on the matrix's path)."""
    pkg = PKGS[name]
    return _ck(name, store, chunk_bytes=1 << 10, policy=pkg.BundleAll(),
               delta_chains=True,
               delta_policy=pkg.DeltaPolicy(max_chain_depth=2), **kw)


def _delta_setup(seed):
    rng = np.random.default_rng(seed)
    mrng = np.random.default_rng(seed + 100)
    return (base_state(rng, rows=256),
            lambda s, i: sparse_mutate_state(s, mrng, i + 1))


@pytest.mark.parametrize("point,flavor", P.delta_matrix_points(),
                         ids=lambda v: str(v))
def test_delta_crash_matrix_matches_reference(tmp_path, point, flavor):
    n_ran = 0
    for n_setup in (1, 3):
        n_ran += _both(tmp_path, f"n{n_setup}", point, flavor, mk_ck=_delta_ck,
                       setup=_delta_setup, n_setup_saves=n_setup, max_depth=2)
    assert n_ran >= 1


def _branchy_remat_history(name, fs):
    """main t1 → branch "dead" t2/t3 (a delta chain) → back on main, the
    same mutations replayed so t4 dedups onto the delta pod → delete
    "dead": GC must re-materialize t4's pod before sweeping its base."""
    ck = _delta_ck(name, fs, fsck_on_open=False)
    s = base_state(np.random.default_rng(3), rows=256)
    t1 = ck.save(_conv(name, s))
    ck.branch("dead")
    mrng = np.random.default_rng(42)
    sparse_mutate_state(s, mrng, 1)
    ck.save(_conv(name, s))
    sparse_mutate_state(s, mrng, 2)
    t3 = ck.save(_conv(name, s))
    ck.checkout("main")
    s = base_state(np.random.default_rng(3), rows=256)
    mrng = np.random.default_rng(42)
    sparse_mutate_state(s, mrng, 1)
    sparse_mutate_state(s, mrng, 2)
    t4 = ck.save(_conv(name, s))
    assert {p["d"] for p in fs.get_manifest(t4)["pods"].values()} == \
        {p["d"] for p in fs.get_manifest(t3)["pods"].values()}
    ck.versions.delete_branch("dead")
    return ck, snapshot_state(s), (t1, t4)


@pytest.mark.parametrize("flavor", ["crash-before", "torn", "crash-after"])
def test_gc_crash_mid_rematerialize_then_fsck_matches_reference(tmp_path,
                                                                 flavor):
    """Kill GC inside the chain rescue.  The sweep never ran, so every
    commit survives; a torn rescue leaves a corrupt whole form shadowing
    a valid delta, which deep fsck drops.  Both packages repair alike
    and a redo GC frees the same with dry run == actual."""
    out = {}
    for name, pkg in PKGS.items():
        root = str(tmp_path / name)
        fs = pkg.FaultyStore(pkg.FileStore(root))
        ck, snap, (t1, t4) = _branchy_remat_history(name, fs)
        fs.clear()
        fs.arm("rematerialize", flavor)
        with pytest.raises(pkg.InjectedCrash):
            ck.gc()
        rep = FSCK[name](pkg.FileStore(root), repair=True, deep=True)
        assert bool(rep.whole_forms_dropped) == (flavor == "torn")
        assert not rep.incomplete
        ck2 = _delta_ck(name, pkg.FileStore(root), fsck_on_open=False)
        assert tree_equal(_np(name, ck2.load(time_id=t4)), snap)
        assert not _no_debris(root)
        dry, real = ck2.gc(dry_run=True), ck2.gc()
        assert real.n_commits_deleted == 2
        assert real.bytes_reclaimed == dry.bytes_reclaimed
        assert tree_equal(_np(name, ck2.load(time_id=t4)), snap)
        out[name] = (results(rep), results(dry), results(real))
    assert out["ref"] == out["port"]
    assert_stores_equal(R.FileStore(str(tmp_path / "ref")),
                        P.FileStore(str(tmp_path / "port")))


# ---------------------------------------------------------------------------
# retries, async crashes, the FaultyStore surface
# ---------------------------------------------------------------------------

def test_save_retries_transient_store_errors_like_reference(tmp_path):
    out = {}
    for name, pkg in PKGS.items():
        fs = pkg.FaultyStore(pkg.FileStore(str(tmp_path / name)))
        ck = _ck(name, fs, retry_policy=pkg.RetryPolicy(backoff_s=0.001))
        s = _mk_state(np.random.default_rng(2))
        ck.save(_conv(name, _mutate(s, 0)))
        fs.transient("put_pod", times=2)
        fs.transient("put_manifest", times=1)
        tid = ck.save(_conv(name, _mutate(s, 1)))
        assert tree_equal(_np(name, ck.load(time_id=tid)), snapshot_state(s))
        out[name] = (ck.save_stats[-1]["n_retries"], dict(fs.calls))
    assert out["ref"] == out["port"] and out["port"][0] == 3
    assert_stores_equal(R.FileStore(str(tmp_path / "ref")),
                        P.FileStore(str(tmp_path / "port")))


def test_injected_crash_not_retried(tmp_path):
    fs = P.FaultyStore(P.FileStore(str(tmp_path)))
    ck = _ck("port", fs)
    s = _mk_state(np.random.default_rng(3))
    ck.save(_conv("port", _mutate(s, 0)))
    fs.clear()
    fs.crash_at("put_pod", when="before")
    with pytest.raises(P.InjectedCrash):
        ck.save(_conv("port", _mutate(s, 1)))
    assert fs.calls["put_pod"] == 1      # one attempt: a crash is no OSError
    assert not issubclass(P.InjectedCrash, Exception)


def test_crash_during_async_save_then_fsck_like_reference(tmp_path):
    """A crashed async body parks its error, wait() surfaces it, fsck
    rolls the torn attempt back and saving resumes, in both packages."""
    out = {}
    for name, pkg in PKGS.items():
        fs = pkg.FaultyStore(pkg.FileStore(str(tmp_path / name)))
        ck = _ck(name, fs, async_mode=True, fsck_on_open=False)
        s = _mk_state(np.random.default_rng(5))
        t1 = ck.save(_conv(name, _mutate(s, 0)))
        ck.wait()
        fs.torn_at("put_manifest")
        ck.save(_conv(name, _mutate(s, 1)))
        with pytest.raises(pkg.InjectedCrash):
            ck.wait()
        assert ck.saver.n_failed == 1
        fs.clear()
        rep = ck.fsck(deep=True)
        assert rep.n_manifests_swept == 1
        assert ck.versions.head_commit() == t1
        t3 = ck.save(_conv(name, _mutate(s, 2)))
        ck.wait()
        assert tree_equal(_np(name, ck.load(time_id=t3)), snapshot_state(s))
        out[name] = (results(rep), t3)
        assert ck.close() == []
    assert out["ref"] == out["port"]
    assert_stores_equal(R.FileStore(str(tmp_path / "ref")),
                        P.FileStore(str(tmp_path / "port")))


def test_faulty_store_faults_match_reference():
    """Torn writes, latency and transient faults of each point leave the
    same bytes and call counts in both packages' stores."""
    out = {}
    for name, pkg in PKGS.items():
        fs = pkg.FaultyStore(pkg.MemoryStore())
        seen = []
        fs.torn_at("put_pod", fraction=0.5)
        with pytest.raises(pkg.InjectedCrash):
            fs.put_pod("aa" * 16, b"0123456789abcdef")
        seen.append(fs.inner._get_raw("aa" * 16))
        fs.transient("put_meta", times=2, skip=1)
        fs.put_meta("k", b"1")
        for _ in range(2):
            with pytest.raises(OSError):
                fs.put_meta("k", b"2")
        fs.put_meta("k", b"3")
        seen.append(fs.get_meta("k"))
        fs.latency("get_meta", 0.0)
        fs.crash_at("cas_meta", when="after")
        with pytest.raises(pkg.InjectedCrash):
            fs.compare_and_put_meta("k", b"3", b"4")
        seen.append(fs.get_meta("k"))
        seen.append(dict(fs.calls))
        fs.clear()
        seen.append(fs.put_pod("bb" * 16, b"x" * 8))
        seen.append(fs.total_bytes())
        out[name] = seen
    assert out["ref"] == out["port"]
