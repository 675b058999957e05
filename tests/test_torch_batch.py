"""Port batched engine and change detector vs the reference, bit-exact.

Plans must equal the reference's field for field; `digest_leaves` and
`digest_leaves_fused` must give the same digests, dirty column and
speculated payload as the reference on the same leaves, with one
counted fetch per call; the change detector must report the same
digests, dirty sets and speculation hits over a mutation sequence.
The reference runs as its own tests run it (Pallas in interpret mode).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.change_detector import ChangeDetector as RefDetector
from repro.core.graph import build_graph as ref_build_graph
from repro.kernels import batch as rbatch
from repro.kernels import ops as rops
from repro_torch.core.change_detector import ChangeDetector
from repro_torch.core.graph import build_graph
from repro_torch.kernels import batch as tbatch
from repro_torch.kernels import ops as tops

from proptest import given, integers, sampled_from

DTYPES = ["float32", "bfloat16", "int8", "bool", "float16", "int32"]


def np_to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy (bfloat16 via its uint16 bits) -> CPU tensor, same bytes."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _leaf(rng, rows, cols, dt):
    x = rng.standard_normal((rows, cols))
    if dt == "bool":
        return x > 0
    if dt == "bfloat16":
        return np.asarray(jnp.asarray(x, jnp.bfloat16))
    if dt in ("int8", "int32"):
        return (x * 50).astype(dt)
    return x.astype(dt)


def _leaves(rng, n):
    return [(f"l{i}", _leaf(rng, int(rng.integers(1, 200)),
                            int(rng.integers(1, 9)),
                            DTYPES[int(rng.integers(0, len(DTYPES)))]))
            for i in range(n)]


@given(n_leaves=integers(1, 6), seed=integers(0, 10_000),
       chunk=sampled_from([64, 256, 1024, 4096]))
def test_plans_equal_reference(n_leaves, seed, chunk):
    rng = np.random.default_rng(seed)
    specs = tuple((k, a.shape, str(a.dtype)) for k, a in _leaves(rng,
                                                                 n_leaves))
    want = rbatch.plan_leaves(specs, chunk)
    got = tbatch.plan_leaves(specs, chunk)
    assert [dataclasses.astuple(s) for s in got.leaves] == \
        [dataclasses.astuple(s) for s in want.leaves]
    assert [dataclasses.astuple(b) for b in got.buckets] == \
        [dataclasses.astuple(b) for b in want.buckets]
    assert got.chunk_bytes == want.chunk_bytes
    assert [x.tolist() for x in tbatch._plan_lengths(got)] == \
        [x.tolist() for x in rbatch._plan_lengths(want)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_digest_leaves_matches_reference(seed):
    rng = np.random.default_rng(seed)
    leaves = _leaves(rng, 5)
    want = rbatch.digest_leaves([(k, jnp.asarray(a)) for k, a in leaves],
                                chunk_bytes=512, seed=5)
    fetches = tops.fetch_count
    got = tbatch.digest_leaves([(k, np_to_torch(a)) for k, a in leaves],
                               chunk_bytes=512, seed=5)
    assert tops.fetch_count == fetches + 1 and got.n_syncs == 1
    assert got.keys == want.keys and got.leaf_rows == want.leaf_rows
    assert (got.mat == want.mat).all()
    host = tbatch.digest_leaves(leaves, chunk_bytes=512, seed=5)
    assert host.n_syncs == 0 and (host.mat == want.mat).all()


@pytest.mark.parametrize("seed,chunk", [(0, 256), (1, 1024), (2, 256)])
def test_digest_leaves_fused_matches_reference(seed, chunk):
    rng = np.random.default_rng(seed)
    leaves = _leaves(rng, 4)
    jl = [(k, jnp.asarray(a)) for k, a in leaves]
    tl = [(k, np_to_torch(a)) for k, a in leaves]
    keys = rbatch.digest_leaves(jl, chunk_bytes=chunk).keys
    spec = {k for k in keys if rng.random() < 0.5}
    prior = {k for k in keys if rng.random() < 0.7}
    base = {k: rng.integers(0, 2**32, 4, dtype=np.uint32).tobytes()
            for k in prior}
    lookup = base.get
    want, rtable = rbatch.digest_leaves_fused(
        jl, chunk_bytes=chunk, lookup=lookup, spec_keys=spec)
    fetches = tops.fetch_count
    got, ttable = tbatch.digest_leaves_fused(
        tl, chunk_bytes=chunk, lookup=lookup, spec_keys=spec)
    assert tops.fetch_count == fetches + 1 and got.n_syncs == 1
    assert got.keys == want.keys and (got.mat == want.mat).all()
    assert (got.dirty == want.dirty).all()
    assert got.payload == want.payload and set(got.payload) == spec
    assert [t.numpy().view(np.uint32).tolist() for t in ttable.digs] == \
        [np.asarray(d).tolist() for d in rtable.digs]

    # second pass against the carried table: all clean, still one fetch
    want2, _ = rbatch.digest_leaves_fused(jl, chunk_bytes=chunk,
                                          table=rtable, spec_keys=spec)
    got2, _ = tbatch.digest_leaves_fused(tl, chunk_bytes=chunk,
                                         table=ttable, spec_keys=spec)
    assert tops.fetch_count == fetches + 2
    assert (got2.dirty == want2.dirty).all() and not got2.dirty.any()
    assert got2.payload == want2.payload


def test_fused_host_rows_are_unknown_and_devices_checked():
    items = [("dev", torch.arange(64, dtype=torch.float32)),
             ("host", np.arange(64, dtype=np.float32))]
    res, _ = tbatch.digest_leaves_fused(items, chunk_bytes=1 << 10,
                                        lookup=lambda k: None)
    dirty = {k: int(d) for k, d in zip(res.keys, res.dirty)}
    assert dirty == {"dev#[0]": 1, "host#[0]": -1}
    with pytest.raises(ValueError):
        tbatch.digest_leaves_fused(items, chunk_bytes=1 << 10,
                                   device=torch.device("meta"))


def test_tree_fingerprint_matches_reference():
    rng = np.random.default_rng(0)
    state = {
        "emb": rng.standard_normal((500, 16)).astype(np.float32),
        "w": np.asarray(jnp.asarray(rng.standard_normal((64, 64)),
                                    jnp.bfloat16)),
        "flags": rng.standard_normal(33) > 0,
        "q": rng.integers(-100, 100, size=(777,)).astype(np.int8),
        "s": np.float32(1.25),
    }
    on_device = {"w", "q"}
    rstate = {k: jnp.asarray(v) if k in on_device else v
              for k, v in state.items()}
    tstate = {k: np_to_torch(v) if k in on_device else v
              for k, v in state.items()}
    want = rops.tree_fingerprint(ref_build_graph(rstate, chunk_bytes=1 << 10),
                                 chunk_bytes=1 << 10, seed=3)
    g = build_graph(tstate, chunk_bytes=1 << 10)
    assert tops.tree_fingerprint(g, chunk_bytes=1 << 10, seed=3) == want
    got, n_syncs = tbatch.tree_fingerprint_batched(g, chunk_bytes=1 << 10,
                                                   seed=3)
    assert got == want and n_syncs == 1


@pytest.mark.parametrize("mode", ["fused", "two_sync", "per_leaf"])
def test_detector_matches_reference(mode):
    """Same mutation sequence through both detectors: same digests, dirty
    sets, fetch counts and speculation hits."""
    rng = np.random.default_rng(4)
    kw = {"fused": dict(), "two_sync": dict(fused=False),
          "per_leaf": dict(fused=False, batched=False)}[mode]

    def state(step):
        w = np.arange(3000, dtype=np.float32)
        w[:200] += step                   # chunk 0 of w flips every save
        return {"w": w, "b": np.full((100,), float(step // 2), np.float32),
                "host": np.arange(32, dtype=np.int32) + step % 3}

    ref = RefDetector(chunk_bytes=1 << 12, **kw)
    port = ChangeDetector(chunk_bytes=1 << 12, **kw)
    for step in range(4):
        st = state(step)
        rg = ref_build_graph({k: v if k == "host" else jnp.asarray(v)
                              for k, v in st.items()}, chunk_bytes=1 << 12)
        tg = build_graph({k: v if k == "host" else torch.from_numpy(v)
                          for k, v in st.items()}, chunk_bytes=1 << 12)
        spec = ({k for k in sorted(ref.export_table()) if rng.random() < 0.5}
                if step else None)
        r = ref.detect(rg, speculate=spec)
        fetches = tops.fetch_count
        t = port.detect(tg, speculate=spec)
        assert t.digests == r.digests and t.dirty == r.dirty
        assert t.n_syncs == r.n_syncs == tops.fetch_count - fetches
        assert t.payload == r.payload and t.fused_rows == r.fused_rows
        assert (t.n_spec_hits, t.n_spec_misses) == (r.n_spec_hits,
                                                    r.n_spec_misses)


def test_detector_rejects_tensor_on_other_device():
    cd = ChangeDetector(chunk_bytes=1 << 12, device="cpu")
    g = build_graph({"w": torch.zeros(8, device="meta")}, chunk_bytes=1 << 12)
    with pytest.raises(ValueError):
        cd.detect(g)
