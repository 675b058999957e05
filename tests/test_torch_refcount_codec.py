"""The refcount index's memo and splice encoder (`version/refcount.py`).

Every index on one store shares a memo of the blob it last read or
wrote; a commit on that blob decodes nothing and packs only the entries
it touched.  Whatever path a mutation takes, the blob it writes must be
the bytes `RefcountIndex._encode` gives for the state a plain model of
the index's rules reaches (tolerance zero), and `_decode` of it must be
that state.  The model here is independent of the module: a dict
updated by the rules the module docstring states.
"""
import copy
import random
import threading

import pytest

from repro_torch.core import Chipmink, FileStore, MemoryStore
from repro_torch.core.checkpoint import SPAN_ONLY_STATS
from repro_torch.version.refcount import (REFCOUNTS_META_KEY,
                                          RefcountIndex, _scan_state)


def empty():
    return {"tids": set(), "counts": {}, "children": {}, "chains": {}}


def digest(rng):
    return "%032x" % rng.getrandbits(128)


def manifest(tid, parent, digs, links=()):
    pods = {str(i): {"d": d} for i, d in enumerate(digs)}
    for j, (d, base) in enumerate(links):
        pods[f"l{j}"] = {"d": d, "delta_of": base}
    return {"time_id": tid, "parent": parent, "pods": pods}


def model_commit(state, tid, m):
    """The index's rule for one commit, on a plain dict."""
    if tid in state["tids"]:
        return
    state["tids"].add(tid)
    for d in {meta["d"] for meta in m["pods"].values()}:
        state["counts"][d] = state["counts"].get(d, 0) + 1
    if m["parent"] is not None:
        state["children"][m["parent"]] = (
            state["children"].get(m["parent"], 0) + 1)
    for meta in m["pods"].values():
        if "delta_of" in meta:
            state["chains"][meta["d"]] = meta["delta_of"]


def model_reclaim(state, dead_tids, pod_dec, dead_pods, child_dec, drop):
    """The index's rule for one reclaim plan, on a plain dict."""
    state["tids"] -= set(dead_tids)
    for d, n in pod_dec.items():
        c = state["counts"].get(d, 0) - n
        if c > 0:
            state["counts"][d] = c
        elif d in dead_pods:
            state["counts"].pop(d, None)
        else:
            state["counts"][d] = 0
    for t, n in child_dec.items():
        c = state["children"].get(t, 0) - n
        if c > 0:
            state["children"][t] = c
        else:
            state["children"].pop(t, None)
    for d in drop:
        state["chains"].pop(d, None)


def assert_blob_is(store, state):
    blob = store.get_meta(REFCOUNTS_META_KEY)
    assert blob == RefcountIndex._encode(state)
    assert RefcountIndex._decode(blob) == state


def make_store(kind, tmp_path):
    return MemoryStore() if kind == "memory" else FileStore(
        str(tmp_path / "store"))


STORES = ("memory", "file")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n_indexes", [2, 3, 4])
@pytest.mark.parametrize("kind", STORES)
def test_random_mutations_write_the_oracles_bytes(kind, n_indexes, seed,
                                                  tmp_path):
    """Commits, reclaims and rebuilds in random order over several
    indexes on one store: after every step the blob is the oracle's."""
    rng = random.Random(1000 * seed + n_indexes)
    store = make_store(kind, tmp_path)
    idx = [RefcountIndex(store) for _ in range(n_indexes)]
    idx[0].ensure()
    model = empty()
    assert_blob_is(store, model)
    pool = [digest(rng) for _ in range(40)]
    tid = 0
    for _ in range(60):
        ix = rng.choice(idx)
        op = rng.random()
        if op < 0.65 or not model["tids"]:
            tid += 1
            digs = rng.sample(pool, rng.randint(0, 12))
            digs += [digest(rng) for _ in range(rng.randint(0, 8))]
            pool += digs[-3:]
            links = [(digest(rng), rng.choice(pool))
                     for _ in range(rng.randint(0, 2))]
            parent = rng.choice(sorted(model["tids"]) + [None])
            m = manifest(tid, parent, digs, links)
            store.put_manifest(tid, m)
            ix.record_commit(tid, m)
            model_commit(model, tid, m)
            if rng.random() < 0.2:      # a retried commit counts once
                ix.record_commit(tid, m)
        elif op < 0.9:
            keys = sorted(model["counts"])
            dec = {d: rng.randint(1, 3)
                   for d in rng.sample(keys, min(len(keys), 6))}
            dec[digest(rng)] = 1        # a digest the index never held
            dead = {d for d in dec if rng.random() < 0.5}
            dead_tids = rng.sample(sorted(model["tids"]), 1)
            kids = {t: 1 for t in rng.sample(sorted(model["children"]),
                                             min(2, len(model["children"])))}
            drop = rng.sample(sorted(model["chains"]),
                              min(2, len(model["chains"])))
            ix.apply_reclaim(dead_tids, dec, dead, kids, drop)
            model_reclaim(model, dead_tids, dec, dead, kids, drop)
        else:
            ix.rebuild()
            model = copy.deepcopy(_scan_state(store))
        assert_blob_is(store, model)
        assert ix.state_snapshot() == model


def test_counts_cross_every_value_width():
    """One digest counted 300 times crosses 127 -> 128 and 255 -> 256;
    reclaims bring it back down and to a pinned zero."""
    store = MemoryStore()
    a, b = RefcountIndex(store), RefcountIndex(store)
    a.ensure()
    model = empty()
    digs = ["0" * 32, "f" * 32]
    for tid in range(1, 301):
        m = manifest(tid, tid - 1 if tid > 1 else None, digs)
        (a if tid % 2 else b).record_commit(tid, m)
        model_commit(model, tid, m)
        assert_blob_is(store, model)
    for n in (44, 1, 127, 1, 126, 1):
        plan = ([], {digs[0]: n}, set(), {}, [])
        a.apply_reclaim(*plan)
        model_reclaim(model, *plan)
        assert_blob_is(store, model)
    assert model["counts"][digs[0]] == 0        # pinned survivor
    a.record_commit(301, manifest(301, 300, digs[:1]))
    model_commit(model, 301, manifest(301, 300, digs[:1]))
    assert_blob_is(store, model)


@pytest.mark.parametrize("start", [126, 254, 65534, 2**32 - 2])
def test_counts_cross_wide_values_after_an_outside_blob(start):
    """A blob put from outside holds counts just below a width; commits
    on the fast path carry them across it."""
    store = MemoryStore()
    ix = RefcountIndex(store)
    model = empty()
    model["counts"] = {"%032x" % i: start for i in range(20)}
    store.put_meta(REFCOUNTS_META_KEY, RefcountIndex._encode(model))
    for tid in range(1, 5):
        m = manifest(tid, None, ["%032x" % i for i in range(0, 20, tid)])
        ix.record_commit(tid, m)
        model_commit(model, tid, m)
        assert_blob_is(store, model)


@pytest.mark.parametrize("start,grow", [(14, 1), (15, 1), (10, 10),
                                        (65534, 1), (65530, 12)])
def test_counts_map_header_crosses_its_forms(start, grow):
    """The `counts` map's header changes form at 16 and 65,536 entries,
    growing by commits and shrinking again by a reclaim."""
    store = MemoryStore()
    ix = RefcountIndex(store)
    model = empty()
    model["counts"] = {"%032x" % (2 * i): 1 for i in range(start)}
    store.put_meta(REFCOUNTS_META_KEY, RefcountIndex._encode(model))
    m = manifest(1, None, ["%032x" % 1])
    ix.record_commit(1, m)              # decodes, seeds the memo
    model_commit(model, 1, m)
    new = ["%032x" % (2 * i + 1) for i in range(1, grow + 1)]
    m = manifest(2, 1, new)
    ix.record_commit(2, m)
    model_commit(model, 2, m)
    assert_blob_is(store, model)
    plan = ([2], {d: 1 for d in new}, set(new), {1: 1}, [])
    ix.apply_reclaim(*plan)
    model_reclaim(model, *plan)
    assert_blob_is(store, model)


KEY_SHAPES = {
    # ASCII of many lengths: the splice, its key array widened
    "ascii_widths": (["k" * n for n in (1, 5, 31, 32, 33)], "z" * 300,
                     True),
    # a key outside ASCII, or holding a NUL: encoded whole
    "non_ascii": (["d%02d" % i for i in range(8)], "d\u00e9", False),
    "nul": (["d%02d" % i for i in range(8)], "d03\x00", False),
}


@pytest.mark.parametrize("shape", sorted(KEY_SHAPES))
def test_keys_of_other_shapes_keep_the_oracles_bytes(shape):
    """Digests are 32 hex characters; keys of other lengths take the
    splice, keys it cannot order as bytes the whole encode."""
    keys, odd, spliced = KEY_SHAPES[shape]
    store = MemoryStore()
    ix = RefcountIndex(store)
    ix.ensure()
    model = empty()
    for tid, digs in enumerate((keys, keys[::2] + [odd], keys[1:]), 1):
        m = manifest(tid, None, digs)
        coded, whole = ix.record_commit(tid, m)
        model_commit(model, tid, m)
        assert_blob_is(store, model)
    # the last commit spliced, or coded every entry it wrote
    assert (coded < whole // 2) == spliced


class RacingStore(MemoryStore):
    """A store where, once, a mutation's CAS on the index loses: a
    peer's blob lands between the read and the CAS (``peer``), or lands
    and is then put back as it was, so the retry reads the bytes it read
    before (``aba``); or the CAS raises (``raise``)."""

    def __init__(self):
        super().__init__()
        self.race = None
        self.peer_blob = None

    def compare_and_put_meta(self, key, expected_old, new):
        race, self.race = self.race, None
        if key != REFCOUNTS_META_KEY or race is None:
            return super().compare_and_put_meta(key, expected_old, new)
        if race == "raise":
            raise OSError("injected: the CAS did not run")
        self.put_meta(key, self.peer_blob)
        assert not super().compare_and_put_meta(key, expected_old, new)
        if race == "aba":
            self.put_meta(key, bytes(expected_old))
        return False


@pytest.mark.parametrize("race", ["peer", "aba", "raise"])
def test_a_lost_cas_drops_the_memo_and_retries_on_the_winner(race):
    rng = random.Random(7)
    store = RacingStore()
    a, b = RefcountIndex(store), RefcountIndex(store)
    a.ensure()
    model = empty()
    for tid in range(1, 4):
        m = manifest(tid, None, [digest(rng) for _ in range(30)])
        a.record_commit(tid, m)
        model_commit(model, tid, m)
    peer = copy.deepcopy(model)
    model_commit(peer, 10, manifest(10, 3, [digest(rng) for _ in range(5)]))
    store.peer_blob = RefcountIndex._encode(peer)
    store.race = race
    winner = peer if race == "peer" else copy.deepcopy(model)
    m = manifest(4, 3, sorted(model["counts"])[:5] + [digest(rng)])
    if race == "raise":
        with pytest.raises(OSError):
            b.record_commit(4, m)
        assert_blob_is(store, model)
    coded, whole = b.record_commit(4, m)    # the caller retries the unit
    model_commit(winner, 4, m)
    assert_blob_is(store, winner)
    assert b.state_snapshot() == winner
    # the retry decoded the blob whole
    assert coded >= whole // 2
    # and the next commit is on the memo again
    m = manifest(5, 4, [digest(rng)])
    coded, whole = a.record_commit(5, m)
    model_commit(winner, 5, m)
    assert_blob_is(store, winner)
    assert coded < whole // 4


@pytest.mark.parametrize("kind", STORES)
def test_a_blob_put_from_outside_is_decoded(kind, tmp_path):
    """Another store's bytes under the key: the memo does not hold them,
    so the next commit decodes them and counts on top."""
    rng = random.Random(11)
    store = make_store(kind, tmp_path)
    ix = RefcountIndex(store)
    ix.ensure()
    other = MemoryStore()
    ox = RefcountIndex(other)
    theirs = empty()
    for tid in range(1, 4):
        m = manifest(tid, None, [digest(rng) for _ in range(20)])
        ox.record_commit(tid, m)
        model_commit(theirs, tid, m)
    mine = empty()
    m = manifest(1, None, [digest(rng) for _ in range(20)])
    ix.record_commit(1, m)
    model_commit(mine, 1, m)
    assert_blob_is(store, mine)
    store.put_meta(REFCOUNTS_META_KEY, other.get_meta(REFCOUNTS_META_KEY))
    m = manifest(9, 3, sorted(theirs["counts"])[:4] + [digest(rng)])
    coded, whole = ix.record_commit(9, m)
    model_commit(theirs, 9, m)
    assert_blob_is(store, theirs)
    assert coded >= whole // 2
    ix.load()
    assert ix.state_snapshot() == theirs


@pytest.mark.parametrize("kind", STORES)
def test_two_threads_commit_through_one_store(kind, tmp_path):
    store = make_store(kind, tmp_path)
    idx = [RefcountIndex(store) for _ in range(4)]
    idx[0].ensure()
    shared = ["%032x" % i for i in range(25)]
    ms = {}
    for t in range(2):
        rng = random.Random(t)
        for k in range(25):
            tid = 1 + t + 2 * k
            ms[tid] = manifest(tid, None, rng.sample(shared, 5)
                               + [digest(rng) for _ in range(5)])
    errors = []

    def run(t):
        try:
            for k in range(25):
                tid = 1 + t + 2 * k
                idx[2 * t + k % 2].record_commit(tid, ms[tid])
        except Exception as e:          # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    model = empty()
    for tid in sorted(ms):
        model_commit(model, tid, ms[tid])
    assert_blob_is(store, model)


def test_a_commit_on_the_memo_codes_its_manifest_not_the_index():
    """After the first commit, a commit of 40 pods codes on the order of
    its manifest, while the index holds thousands of entries."""
    rng = random.Random(3)
    store = MemoryStore()
    ix = RefcountIndex(store)
    model = empty()
    model["counts"] = {digest(rng): 1 for _ in range(5000)}
    store.put_meta(REFCOUNTS_META_KEY, RefcountIndex._encode(model))
    m = manifest(1, None, [digest(rng) for _ in range(40)])
    coded, whole = ix.record_commit(1, m)
    assert coded >= whole // 2          # decoded, encoded whole
    for tid in (2, 3):
        m = manifest(tid, tid - 1, [digest(rng) for _ in range(40)])
        coded, whole = ix.record_commit(tid, m)
        assert whole == 2 * (tid + 5000 + 40 * tid + tid - 1)
        assert coded <= 40 + 2 * tid
    # an index that only loaded the blob codes as little
    other = RefcountIndex(store)
    other.load()
    coded, _ = other.record_commit(4, manifest(4, 3, [digest(rng)]))
    assert coded <= 1 + 2 * 4


def test_chipmink_reports_the_counters_and_keeps_them_out_of_manifests():
    import torch

    store = MemoryStore()
    ck = Chipmink(store, refcounts=True, device="cpu")
    state = {"w": torch.arange(4096, dtype=torch.float32)}
    for step in range(3):
        state["w"][step] += 1
        ck.save(state)
    for st in ck.save_stats:
        assert 0 < st["n_refcount_coded"] <= st["n_refcount_whole"]
    assert {"n_refcount_coded", "n_refcount_whole"} <= SPAN_ONLY_STATS
    for tid in store.list_time_ids():
        assert "n_refcount_coded" not in store.get_manifest(tid)["stats"]
    plain = Chipmink(MemoryStore(), device="cpu")
    plain.save(state)
    assert "n_refcount_coded" not in plain.save_stats[-1]
