"""Port `FlipTracker` vs the reference's, on the CPU.

The port keeps the flip EMA as an array aligned with the active keys of
the last observe.  Over a sequence of observes (a first save, unchanged
saves with varying dirty sets, every chunk named by a list or by None,
an active key with no node, a key leaving the active set, chunks added,
a re-shaped leaf) the two trackers must agree: `ema` bit for bit and
`predicted()`.  The save path's `chunk_keys` must name the chunks the
reference's call site names, and the per-save counters stay out of the
manifests.
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


def assert_same(ref, port):
    assert port.ema == ref.ema
    assert all(np.float64(port.ema[k]).tobytes()
               == np.float64(v).tobytes() for k, v in ref.ema.items())
    for thr in (0.1, 0.25, 0.5):
        assert port.predicted(thr) == ref.predicted(thr)


def steps():
    """(state, active-keys rule, dirty rule) per save; the rules take the
    graph's chunk keys (and a generator); a rule of None names every
    chunk active."""
    some = lambda share: (lambda keys, rng: [k for k in keys
                                             if rng.random() < share])
    return [
        (state(0), None, some(1.0)),                            # first save
        (state(1), None, some(0.3)),
        (state(2), None, some(0.05)),
        (state(3), None, some(0.5)),
        (state(4), lambda keys: list(keys) + [GHOST], some(0.2)),
        (state(5), lambda keys: [k for k in keys               # leaves
                                 if not k.startswith("cache/")], some(0.4)),
        (state(6, extra=True), None, some(0.3)),                # adds chunks
        (state(7, shape1=(40, 32), extra=True), None, some(0.3)),   # reshape
        (state(8, shape1=(40, 32), extra=True), None, some(0.0)),
        (state(9, shape1=(40, 32), extra=True), None, some(0.6)),
    ]


@pytest.mark.parametrize("every_as", ["list", "none"])
def test_tracker_matches_the_reference(every_as):
    """`every_as` is how a save whose active keys are all the chunks
    names them: as a list of their keys, or as None."""
    ref, port = RefTracker(), FlipTracker()
    rcache, pcache = RefGraphCache(chunk_bytes=CHUNK_BYTES), \
        GraphCache(chunk_bytes=CHUNK_BYTES)
    rng = np.random.default_rng(26)
    for i, (st, active_rule, dirty_rule) in enumerate(steps()):
        rg, _ = rcache.build(st)
        pg, _ = pcache.build(as_torch(st))
        keys = chunk_keys(pg)
        assert keys == chunk_keys(rg)
        if active_rule is None:
            active = None if every_as == "none" else list(keys)
        else:
            active = active_rule(keys)
        dirty = dirty_rule(keys, rng) + ["params/layers_0/w#[999]"]
        ref.observe(rg, list(dirty), active)
        n_keys = port.observe(pg, dirty, active)
        assert_same(ref, port)
        assert n_keys == len(set(active if active is not None else keys))
        if i == 4:
            # an active key with no node gets an EMA, as in the reference
            assert GHOST in port.ema


def test_chunk_keys_name_the_reference_call_sites_chunks():
    """`chunk_keys` gives the chunks of the active leaves, as the
    reference's call site (every chunk whose path is an active leaf):
    on a first build, an unchanged build, a re-shaped leaf's and a graph
    built afresh (a checkout's)."""
    tr = FlipTracker()
    cache = GraphCache(chunk_bytes=CHUNK_BYTES)

    def reference_keys(graph, active):
        return sorted(n.key for n in graph.nodes.values()
                      if n.kind == CHUNK and "/".join(n.path) in active)

    g, _ = cache.build(as_torch(state(0)))
    leaves = {n.key for n in g.leaf_nodes()} - {"cache/kv"}
    keys = tr.chunk_keys(g, leaves | {"step", "nowhere"})
    assert sorted(keys) == reference_keys(g, leaves) and len(keys) == len(
        set(keys))
    g, _ = cache.build(as_torch(state(1)))
    keys2 = tr.chunk_keys(g, leaves)
    assert keys2 == keys
    g, _ = cache.build(as_torch(state(2, shape1=(40, 32))))
    keys3 = tr.chunk_keys(g, leaves)
    assert sorted(keys3) == reference_keys(g, leaves) and keys3 != keys
    fresh = build_graph(as_torch(state(3, shape1=(40, 32))),
                        chunk_bytes=CHUNK_BYTES)
    keys4 = tr.chunk_keys(fresh, leaves)
    assert keys4 == keys3


def test_session_saves_count_rows_built_and_keep_them_out_of_manifests():
    """Every session save updates the EMA of each chunk (`n_track_rows`)
    and builds no feature row (`n_track_rows_built` is 0); the counters
    stay out of the manifests' stats block."""
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
    tracker = svc.sessions["a"].lineage.tracker
    assert len(tracker.ema) == n_chunks
    for stats in (first, second):
        assert stats["n_track_rows"] == n_chunks
        assert stats["n_track_rows_built"] == 0
    assert second["n_dirty_chunks"] >= 1
    assert {"n_track_rows", "n_track_rows_built"} <= SPAN_ONLY_STATS
    for tid in tids:
        kept = svc.store.get_manifest(tid)["stats"]
        assert "n_chunks" in kept
        assert not {"n_track_rows", "n_track_rows_built"} & set(kept)
    svc.close()
