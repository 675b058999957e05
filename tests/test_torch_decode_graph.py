"""The port's compiled decode step (`repro_torch.train.serve_step.
compile_decode_step`, a `DecodeGraph` per session) against the
reference's jitted step, on the CPU, at the reduced configs of every
family `serve` takes.

On the CPU a `DecodeGraph` runs the body a card replays, eagerly,
through the same static buffers (token buffer, the session's own cache
tensors, logits buffer), so these tests cover the plumbing of the graph:
the cache handed back is one dict of the same tensors at every step,
``pos`` advances in place, a resumed session steps on as an
uninterrupted one, and `serve` and `greedy_generate` decode through it.

Numerics: the reference runs as `repro.launch.serve` runs it,
`jax.jit(make_decode_step(cfg))`.  Under `jax.jit` XLA fuses bf16
elementwise chains and skips the roundings the port reproduces op by op
(`test_torch_models.py`), so the model tests' ``TOL`` (absolute and
relative 2e-2, about five bf16 ulps at unit scale) holds against the
reference run op by op, not against the jitted one: over 12 steps of the
reduced configs 99.22-100% of each tensor's elements stay within it and
up to 8 of a step's 1,024 logits pass it.  So logits and every cache leaf
are held to ``TOL_ALL`` (absolute and relative 4e-2, the bound `chip_
smoke.py` phase 11a holds every element of the card's tensors to) and at
least ``TOL_SHARE`` (99%) of each tensor's elements to ``TOL``: at most
10 of a step's 1,024 logits outside it.  (Phase 11a's share, 99.9%, is
for full-width tensors, where a thousandth is many elements; the card
test in `test_torch_decode_graph_card.py` applies it.)  The chain to the
op-by-op reference is closed by
`test_decode_graph_equals_the_eager_step_bit_for_bit` (the graph's body
against the eager step, equal bits) and the model tests (the eager step
against the reference, ``TOL``).  Session stores are compared bit for
bit: the reference's service saves the port's values.

The tests that need a card (capture leaves the cache untouched; the
graph against the eager step) are in `test_torch_decode_graph_card.py`,
which imports no JAX, so they run on a machine with a card and no JAX.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as ref_model
from repro.models import whisper as ref_whisper
from repro.train import serve_step as ref_serve_step
from repro_torch.configs import get_config
from repro_torch.core import MemoryStore
from repro_torch.launch import serve as serve_mod
from repro_torch.models import model
from repro_torch.models.convert import cache_from_numpy
from repro_torch.sessions import SessionService
from repro_torch.train import serve_step
from repro_torch.train.tree import tree_map

from test_torch_checkpoint import to_jax
from test_torch_models import TOL, f32, pair, tokens
from test_torch_sessions import fleet, ref_svc
from test_torch_version import assert_stores_equal, from_torch
from test_torch_whisper import frames

#: every family `serve` takes, at the configurations `chip_smoke.py`
#: phases 9 and 11 serve at full width
SERVED = ("qwen1.5-0.5b", "granite-moe-3b-a800m", "falcon-mamba-7b",
          "recurrentgemma-9b", "whisper-base", "qwen2-vl-2b")
#: every element within TOL_ALL and a share of at least TOL_SHARE
#: within TOL (see the module docstring)
TOL_ALL = dict(rtol=4e-2, atol=4e-2)
TOL_SHARE = 0.99
B, T, STEPS = 2, 8, 12
SRC = Path(__file__).resolve().parents[1] / "src"


def assert_near(got, want, what):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, err_msg=what, **TOL_ALL)
    share = np.isclose(got, want, **TOL).mean() if got.size else 1.0
    assert share >= TOL_SHARE, f"{what}: {share:.5f} within {TOL}"


def leaves(cache):
    return {(i, k): v for i, lc in cache["layers"].items()
            for k, v in lc.items()}


def caches(cfg, rp, batch=B, cache_len=T):
    """(reference cache, port cache) with equal bits; Whisper's cross K/V
    the reference's, carried over."""
    rcache = ref_model.api(cfg).init_cache(cfg, batch, cache_len)
    pcache = model.api(cfg).init_cache(cfg, batch, cache_len, device="cpu")
    if cfg.encoder is not None:
        rf, _ = frames(cfg, batch)
        rcache["cross"] = ref_whisper.build_cross_cache(
            rp, ref_whisper.encode(rp, rf, cfg), cfg)
        pcache["cross"] = cache_from_numpy(
            jax.tree.map(np.asarray, rcache["cross"]), "cpu")
    return rcache, pcache


@pytest.mark.parametrize("arch_id", SERVED)
def test_decode_graph_matches_the_jitted_reference(arch_id):
    """12 steps, past the attention rings of 8 slots; the cache handed
    back is the session's, one dict of the same tensors at every step,
    and ``pos`` advances in place."""
    cfg = get_config(arch_id).reduced()
    rp, pp = pair(cfg)
    rcache, pcache = caches(cfg, rp)
    first = leaves(pcache)
    pos, cross = pcache["pos"], pcache.get("cross")
    rstep = jax.jit(ref_serve_step.make_decode_step(cfg))
    step = serve_step.compile_decode_step(cfg, pp, pcache, device="cpu")
    assert step.graph is None
    toks = tokens(cfg, (B, STEPS))
    for i in range(STEPS):
        tk = toks[:, i:i + 1]
        rlog, rcache = rstep(rp, rcache, jnp.asarray(tk))
        plog, got = step(torch.from_numpy(tk))
        what = f"{arch_id} step {i}"
        assert got is step.cache and plog is step.logits
        assert list(got) == sorted(got)
        assert list(got["layers"]) == sorted(got["layers"])
        assert got["pos"] is pos and int(pos) == int(rcache["pos"]) == i + 1
        assert got.get("cross") is cross
        assert plog.dtype == torch.bfloat16 and plog.shape == (B, cfg.vocab)
        assert_near(plog, rlog, what + " logits")
        assert sorted(leaves(got)) == sorted(leaves(rcache))
        for key, want in leaves(rcache).items():
            assert leaves(got)[key] is first[key], key
            assert_near(first[key], want, f"{what} {key}")


@pytest.mark.parametrize("arch_id", SERVED)
def test_decode_graph_equals_the_eager_step_bit_for_bit(arch_id):
    """On the CPU the graph's body is the eager step: equal bits."""
    cfg = get_config(arch_id).reduced()
    rp, pp = pair(cfg)
    m = model.api(cfg)
    eager = caches(cfg, rp)[1]
    step = serve_step.compile_decode_step(cfg, pp, caches(cfg, rp)[1],
                                          device="cpu")
    toks = torch.from_numpy(tokens(cfg, (B, STEPS)))
    for i in range(STEPS):
        want, eager = m.decode_step(pp, eager, toks[:, i:i + 1], cfg)
        got, cache = step(toks[:, i:i + 1])
        assert torch.equal(got, want)
        assert torch.equal(cache["pos"], eager["pos"])
        for key, leaf in leaves(eager).items():
            assert torch.equal(leaves(cache)[key], leaf), (i, key)


@pytest.mark.parametrize("arch_id", ["qwen1.5-0.5b", "recurrentgemma-9b",
                                     "whisper-base"])
def test_resumed_session_steps_on_as_an_uninterrupted_one(arch_id):
    """Save after 5 steps, resume the session on a second service, compile
    a new step over the restored cache (the old graph is bound to the old
    tensors) and take 7 more: logits and caches equal, bit for bit, an
    uninterrupted run's."""
    cfg = get_config(arch_id).reduced()
    rp, pp = pair(cfg)
    _, cache = caches(cfg, rp)
    _, whole_cache = caches(cfg, rp)
    toks = torch.from_numpy(tokens(cfg, (B, STEPS)))
    whole = serve_step.compile_decode_step(cfg, pp, whole_cache,
                                           device="cpu")
    want = [whole(toks[:, i:i + 1])[0].clone() for i in range(STEPS)]
    step = serve_step.compile_decode_step(cfg, pp, cache, device="cpu")
    for i in range(5):
        step(toks[:, i:i + 1])
    store = MemoryStore()
    svc = SessionService(store, pool_size=1, chunk_bytes=1 << 10,
                         device="cpu")
    svc.open_session("a")
    svc.save_session("a", {"cache": step.cache, "cursor": {"pos": 5}})
    step(toks[:, 5:6])                      # the old session runs on
    other = SessionService(store, pool_size=1, chunk_bytes=1 << 10,
                           device="cpu")
    state = other.resume_session("a")
    assert state["cursor"] == {"pos": 5} and int(state["cache"]["pos"]) == 5
    resumed = serve_step.compile_decode_step(cfg, pp, state["cache"],
                                             device="cpu")
    for i in range(5, STEPS):
        got, cache = resumed(toks[:, i:i + 1])
        assert torch.equal(got, want[i]), i
    assert cache["layers"] is not step.cache["layers"]
    assert torch.equal(cache["pos"], whole.cache["pos"])
    for key, leaf in leaves(whole.cache).items():
        assert torch.equal(leaves(cache)[key], leaf), key
    if cfg.encoder is not None:
        for i, lc in whole.cache["cross"].items():
            for k, v in lc.items():
                assert torch.equal(cache["cross"][i][k], v)
    svc.close(), other.close()


@pytest.mark.parametrize("async_mode", [False, True])
@pytest.mark.parametrize("arch_id", ["qwen1.5-0.5b", "whisper-base"])
def test_session_stores_equal_the_reference(arch_id, async_mode):
    """Two sessions decode through their graphs and save every 4 steps;
    the reference's service saves the same values at the same points.
    Manifests (minus `stats`), pods and meta blobs equal, bit for bit,
    and the fleet's roll-up without timings."""
    cfg = get_config(arch_id).reduced()
    rp, pp = pair(cfg)
    kw = dict(pool_size=2, chunk_bytes=1 << 10, fsck_on_open=False,
              async_mode=async_mode)
    rsvc = ref_svc(**kw)
    psvc = SessionService(MemoryStore(), device="cpu", **kw)
    steps = []
    for s in range(2):
        rsvc.open_session(f"s{s}")
        psvc.open_session(f"s{s}")
        steps.append(serve_step.compile_decode_step(
            cfg, pp, caches(cfg, rp)[1], device="cpu"))
    toks = [tokens(cfg, (B, STEPS), seed=3 + s) for s in range(2)]
    for i in range(STEPS):
        for s, step in enumerate(steps):
            _, cache = step(torch.from_numpy(toks[s][:, i:i + 1]))
            if (i + 1) % 4:
                continue
            state = {"cache": cache, "cursor": {"pos": i + 1}}
            tr = rsvc.save_session(f"s{s}", to_jax(from_torch(state)))
            assert psvc.save_session(f"s{s}", state) == tr
    for ck in rsvc.pool + psvc.pool:
        ck.wait()
    assert_stores_equal(rsvc.store, psvc.store)
    assert fleet(rsvc, not async_mode) == fleet(psvc, not async_mode)
    assert rsvc.close() == [] and psvc.close() == []


def test_serve_builds_one_graph_per_session(monkeypatch):
    """`serve` decodes every session through its own compiled step, over
    that session's cache."""
    built = []

    def spy(cfg, params, cache, *, device):
        built.append(serve_step.compile_decode_step(cfg, params, cache,
                                                    device=device))
        return built[-1]

    monkeypatch.setattr(serve_mod, "compile_decode_step", spy)
    res = serve_mod.serve("whisper-base", n_sessions=3, gen_tokens=8,
                          log=False, device="cpu")
    assert len(built) == 3 and len({id(g.cache) for g in built}) == 3
    assert all(int(g.cache["pos"]) == 16 for g in built)
    assert res["tokens"].shape == (4, 8)
    res["service"].close()


def test_greedy_generate_decodes_through_the_compiled_step(monkeypatch):
    """One compiled step per call; its tokens are the eager step's."""
    cfg = get_config("qwen2-vl-2b").reduced()
    _, pp = pair(cfg, seed=2)
    prompt = torch.from_numpy(tokens(cfg, (2, 5), seed=2))
    built = []
    real = serve_step.compile_decode_step

    def spy(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    monkeypatch.setattr(serve_step, "compile_decode_step", spy)
    got = serve_step.greedy_generate(cfg, pp, prompt, n_steps=6,
                                     cache_len=16)
    assert len(built) == 1 and int(built[0].cache["pos"]) == 5 + 5
    m = model.api(cfg)
    cache = m.init_cache(cfg, 2, 16, device="cpu")
    for i in range(5):
        logits, cache = m.decode_step(pp, cache, prompt[:, i:i + 1], cfg)
    want = [torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)]
    for _ in range(5):
        logits, cache = m.decode_step(pp, cache, want[-1], cfg)
        want.append(torch.argmax(logits, dim=-1, keepdim=True)
                    .to(torch.int32))
    assert torch.equal(got, torch.cat(want, dim=1))


def test_compile_refuses_leaves_off_its_device():
    cfg = get_config("qwen1.5-0.5b").reduced()
    m = model.api(cfg)
    params = model.init_model_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    with pytest.raises(ValueError, match="meta"):
        serve_step.compile_decode_step(
            cfg, params, m.init_cache(cfg, B, T, device="meta"),
            device="cpu")
    with pytest.raises(ValueError, match="neither"):
        serve_step.compile_decode_step(
            cfg, params, m.init_cache(cfg, B, T, device="cpu"),
            device="meta")


def test_compile_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path is tested on it")
    cfg = get_config("qwen1.5-0.5b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_step.compile_decode_step(cfg, {}, {"layers": {}, "pos": None})
    with pytest.raises(RuntimeError):
        serve_mod.serve("qwen1.5-0.5b", n_sessions=1, gen_tokens=1,
                        log=False)


_DTENSOR = r"""
import json, torch
from torch.distributed.tensor import Replicate
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import model
from repro_torch.parallel.sharding import from_local
from repro_torch.train import serve_step
from repro_torch.train.tree import tree_map
cfg = get_config("qwen1.5-0.5b").reduced()
m = model.api(cfg)
params = model.init_model_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
cache = m.init_cache(cfg, 2, 8, device="cpu")
with dryrun.fake_world(4):
    mesh = make_mesh_compat((2, 2), ("data", "model"), device_type="cpu")
    k = cache["layers"]["0"]["k"]
    cache["layers"]["0"]["k"] = from_local(k, mesh, [Replicate()] * 2,
                                           k.shape)
    try:
        serve_step.compile_decode_step(cfg, params, cache, device="cpu")
        err = None
    except TypeError as e:
        err = str(e)
print("JSON=" + json.dumps(err))
"""


def test_compile_refuses_dtensors():
    """A mesh's step never goes through a graph (a fake process group in
    a subprocess: a process group is global to its process)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _DTENSOR], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(l for l in out.stdout.splitlines() if l.startswith("JSON="))
    assert "DTensor" in json.loads(line[5:])
