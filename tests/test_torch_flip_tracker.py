"""Port `FlipTracker` vs the reference's, on the CPU.

The port keeps the flip EMA and the static feature rows (features 0–8)
as arrays across saves and rebuilds a row only where `changed_keys`
names the key, where the key is new to it, or where no changed keys are
given.  Over a sequence of observes (a first save, unchanged saves with
varying dirty sets, ``active_keys=None``, an active key with no node, a
key leaving the active set, chunks added, a re-shaped leaf) the two
trackers must agree: `ema` bit for bit, `predicted()`, and each save's
samples as a multiset (the reference walks a set, the port the active
keys in order); `fit_gbm` then fits the same stumps.  The save path's
`chunk_keys` must name the chunks the reference's call site names, and
the per-save counters stay out of the manifests.
"""
import numpy as np
import pytest
import torch

from repro.core.graph_cache import GraphCache as RefGraphCache
from repro.core.volatility import FlipTracker as RefTracker
from repro_torch.core import MemoryStore
from repro_torch.core.checkpoint import SPAN_ONLY_STATS
from repro_torch.core.graph import CHUNK, build_graph
from repro_torch.core.graph_cache import GraphCache
from repro_torch.core.volatility import FlipTracker
from repro_torch.sessions import SessionService

CHUNK_BYTES = 1 << 10
GHOST = "params/ghost#[0]"      # an active key with no node


def state(step, shape1=(48, 32), extra=False):
    """A small training-like state: parameters in two layers, an
    optimizer moment, a cache and a step counter; `extra` adds a leaf."""
    rng = np.random.default_rng(step)
    st = {"params": {"layers_0": {"w": rng.standard_normal((64, 32))
                                  .astype(np.float32)},
                     "layers_1": {"w": rng.standard_normal(shape1)
                                  .astype(np.float32)}},
          "opt_state": {"mu": {"w": rng.standard_normal((64, 32))
                               .astype(np.float32)}},
          "cache": {"kv": rng.integers(0, 9, (16, 32)).astype(np.int32)},
          "step": step}
    if extra:
        st["params"]["layers_2"] = {"w": rng.standard_normal((40, 32))
                                    .astype(np.float32)}
    return st


def as_torch(tree):
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def chunk_keys(graph):
    return [n.key for n in graph.nodes.values() if n.kind == CHUNK]


def samples(tracker, start):
    """The rows and labels a tracker collected since sample `start`, as
    one array of rows (features, label) sorted lexicographically."""
    X = np.asarray(np.stack(list(tracker.samples_X[start:]))
                   if len(tracker.samples_X) > start
                   else np.zeros((0, 10)))
    y = np.asarray(tracker.samples_y[start:], dtype=np.float64)
    rows = np.column_stack([X, y])
    return rows[np.lexsort(rows.T[::-1])]


def assert_same(ref, port, ref_start, port_start):
    assert port.ema == ref.ema
    assert all(np.float64(port.ema[k]).tobytes()
               == np.float64(v).tobytes() for k, v in ref.ema.items())
    for thr in (0.1, 0.25, 0.5):
        assert port.predicted(thr) == ref.predicted(thr)
    want, got = samples(ref, ref_start), samples(port, port_start)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


def steps():
    """(state, active-keys rule, dirty rule) per save; the rules take the
    graph's chunk keys and a generator."""
    every = lambda keys: list(keys)
    some = lambda share: (lambda keys, rng: [k for k in keys
                                             if rng.random() < share])
    return [
        (state(0), every, some(1.0)),                           # first save
        (state(1), every, some(0.3)),
        (state(2), every, some(0.05)),
        (state(3), None, some(0.5)),                            # None
        (state(4), lambda keys: every(keys) + [GHOST], some(0.2)),
        (state(5), lambda keys: [k for k in keys               # leaves
                                 if not k.startswith("cache/")], some(0.4)),
        (state(6, extra=True), every, some(0.3)),               # adds chunks
        (state(7, shape1=(40, 32), extra=True), every, some(0.3)),  # reshape
        (state(8, shape1=(40, 32), extra=True), every, some(0.0)),
        (state(9, shape1=(40, 32), extra=True), every, some(0.6)),
    ]


@pytest.mark.parametrize("with_changed", [True, False],
                         ids=["changed_keys", "changed_keys_none"])
def test_tracker_matches_the_reference(with_changed):
    ref, port = RefTracker(), FlipTracker()
    rcache, pcache = RefGraphCache(chunk_bytes=CHUNK_BYTES), \
        GraphCache(chunk_bytes=CHUNK_BYTES)
    rng = np.random.default_rng(26)
    prev_rows = {}
    for i, (st, active_rule, dirty_rule) in enumerate(steps()):
        rg, _ = rcache.build(st)
        pg, info = pcache.build(as_torch(st))
        keys = chunk_keys(pg)
        assert keys == chunk_keys(rg)
        active = active_rule(keys) if active_rule else None
        dirty = dirty_rule(keys, rng) + ["params/layers_0/w#[999]"]
        r0, p0 = len(ref.samples_X), len(port.samples_X)
        ref.observe(rg, list(dirty), active)
        n_rows, n_built = port.observe(
            pg, dirty, active,
            changed_keys=info.rebuilt_keys if with_changed else None)
        assert_same(ref, port, r0, p0)
        observed = [k for k in (active if active is not None else keys)
                    if k in pg.by_key]
        assert n_rows == len(observed)
        rows = dict(zip(observed, port.samples_X[p0:]))
        if not with_changed:
            assert n_built == n_rows
        elif i == 0:
            assert n_built == len(keys)
        elif i in (1, 2, 3, 4, 5):
            assert n_built == 0
        elif i == 6:
            # the new leaf's chunks, and the cache's, back in the active
            # keys after a save away
            assert n_built == sum(k.startswith(("params/layers_2/",
                                                "cache/")) for k in keys)
        elif i == 7:
            # the re-shaped leaf keeps its keys and gets new features 0–8
            moved = [k for k in keys if k.startswith("params/layers_1/")]
            assert n_built == len(moved) and moved
            assert all(k in info.rebuilt_keys for k in moved)
            assert all(not np.array_equal(rows[k][:9], prev_rows[k][:9])
                       for k in moved if k in prev_rows)
        elif i == 8:
            assert n_built == 0
        prev_rows.update(rows)
    assert len(port.samples_X) == len(ref.samples_X)

    r_model = ref.fit_gbm(n_estimators=20)
    p_model = port.fit_gbm(n_estimators=20)
    assert [(s.feature, s.threshold) for s in p_model.stumps] == \
        [(s.feature, s.threshold) for s in r_model.stumps]
    assert len(p_model.stumps) > 0
    X = port.samples_X
    np.testing.assert_allclose(p_model.predict(X), r_model.predict(X),
                               rtol=0, atol=1e-9)


def test_chunk_keys_name_the_reference_call_sites_chunks():
    """`chunk_keys` gives the chunks of the active leaves, as the
    reference's call site (every chunk whose path is an active leaf);
    the chunks of a leaf whose node changed are named changed: none on
    an unchanged build, the re-shaped leaf's, and all of them on a
    graph built afresh (a checkout's)."""
    tr = FlipTracker()
    cache = GraphCache(chunk_bytes=CHUNK_BYTES)

    def reference_keys(graph, active):
        return sorted(n.key for n in graph.nodes.values()
                      if n.kind == CHUNK and "/".join(n.path) in active)

    g, _ = cache.build(as_torch(state(0)))
    leaves = {n.key for n in g.leaf_nodes()} - {"cache/kv"}
    keys, changed = tr.chunk_keys(g, leaves | {"step", "nowhere"})
    assert sorted(keys) == reference_keys(g, leaves) and len(keys) == len(
        set(keys))
    assert changed == set(keys)
    g, _ = cache.build(as_torch(state(1)))
    keys2, changed = tr.chunk_keys(g, leaves)
    assert keys2 == keys and changed == set()
    g, info = cache.build(as_torch(state(2, shape1=(40, 32))))
    keys3, changed = tr.chunk_keys(g, leaves)
    assert sorted(keys3) == reference_keys(g, leaves)
    assert changed == {k for k in keys3 if k.startswith("params/layers_1/")}
    fresh = build_graph(as_torch(state(3, shape1=(40, 32))),
                        chunk_bytes=CHUNK_BYTES)
    keys4, changed = tr.chunk_keys(fresh, leaves)
    assert keys4 == keys3 and changed == set(keys4)


def test_session_saves_count_rows_built_and_keep_them_out_of_manifests():
    """A session's first save builds every chunk's row and a save of an
    unchanged structure builds none; the counters stay out of the
    manifests' stats block."""
    svc = SessionService(MemoryStore(), device="cpu", pool_size=1,
                         chunk_bytes=CHUNK_BYTES, fsck_on_open=False)
    svc.open_session("a")
    st = as_torch(state(0))
    tids = [svc.save_session("a", st)]
    st["cache"]["kv"][3] += 1
    st["step"] = 1
    tids.append(svc.save_session("a", st))
    ck = svc.pool[0]
    first, second = ck.save_stats[-2:]
    n_chunks = len(chunk_keys(build_graph(st, chunk_bytes=CHUNK_BYTES)))
    assert first["n_track_rows"] == first["n_track_rows_built"] == n_chunks
    assert second["n_track_rows"] == n_chunks
    assert second["n_track_rows_built"] == 0
    assert second["n_dirty_chunks"] >= 1
    assert {"n_track_rows", "n_track_rows_built"} <= SPAN_ONLY_STATS
    for tid in tids:
        kept = svc.store.get_manifest(tid)["stats"]
        assert "n_chunks" in kept
        assert not {"n_track_rows", "n_track_rows_built"} & set(kept)
    svc.close()
