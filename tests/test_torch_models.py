"""The port's model substrate (`repro_torch.configs`, `models`,
`train.serve_step`) vs the reference package, on the CPU.

Configs and parameter declarations must be equal exactly.  Numerics are
held to a tolerance, against the reference's functions run op by op
(not under `jax.jit`): both packages compute `dense` in bf16 (bf16
result, bias added in bf16), scores, softmax, norms and RoPE in float32,
and round every step of an activation to bf16, so what differs is the
order of float sums inside a product and `tanh`'s last bit, a bf16 ulp
here and there that two layers carry to the logits.  ``TOL``, an
absolute and relative 2e-2, is about five bf16 ulps at unit scale.
Under `jax.jit` XLA fuses the bf16 elementwise chains and skips their
intermediate roundings, which moves the reference itself; the port
reproduces the op-by-op casts.  The reference's parameters are carried
over with `params_from_numpy`, and both packages see the same tokens,
made with numpy from a seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import model as ref_model
from repro.models import attention as ref_attention
from repro.train import serve_step as ref_serve_step
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import attention, model, transformer
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.train import serve_step

DENSE = ("qwen1.5-0.5b", "qwen2.5-14b", "starcoder2-3b", "starcoder2-7b")
#: absolute and relative tolerance on bf16 logits, K/V caches and hidden
#: states of the reduced configs (see the module docstring)
TOL = dict(rtol=2e-2, atol=2e-2)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def ref_params(cfg, seed=0):
    """The reference's random parameters, as numpy (bf16 kept)."""
    params = ref_model.init_model_params(cfg, jax.random.key(seed))
    return jax.tree.map(np.asarray, params)


def pair(cfg, seed=0):
    """(reference params (jax), port params (tensors)) with equal bits."""
    host = ref_params(cfg, seed)
    return jax.tree.map(jnp.asarray, host), params_from_numpy(host, "cpu")


def tokens(cfg, shape, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=shape).astype(np.int32)


def assert_close(got, want, what):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)


def assert_argmax_agrees(got, want, what):
    """Greedy tokens agree wherever the reference's top-2 margin exceeds
    the tolerance (closer calls may flip either way)."""
    got, want = f32(got), f32(want)
    top2 = np.sort(want, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    tol = TOL["atol"] + TOL["rtol"] * np.abs(top2[..., 1])
    sure = margin > 2 * tol
    assert np.array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure]), what


# ---------------------------------------------------------------------------
# configs and parameter declarations (exact)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", sorted(REF_ARCHS))
def test_configs_equal_the_reference(arch_id):
    ref = REF_ARCHS[arch_id]
    port = get_config(arch_id)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert port.layer_plan() == ref.layer_plan()
    assert sorted(ARCHS) == sorted(REF_ARCHS)


def _dtype_name(dt):
    if dt is None:
        return None
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


@pytest.mark.parametrize("arch_id", sorted(REF_ARCHS))
def test_param_defs_equal_the_reference_at_full_width(arch_id):
    """Abstract: paths, shapes, dtype names, axes and inits of every
    parameter; no allocation."""
    cfg = get_config(arch_id)
    ref = ref_model.api(REF_ARCHS[arch_id]).param_defs(REF_ARCHS[arch_id])
    port = model.api(cfg).param_defs(cfg)
    assert sorted(port) == sorted(ref)
    for path, d in ref.items():
        p = port[path]
        assert (p.shape, _dtype_name(p.dtype), p.axes, p.init, p.scale()) \
            == (d.shape, _dtype_name(d.dtype), d.axes, d.init, d.scale()), \
            path
    assert model.count_params(cfg) == ref_model.count_params(REF_ARCHS[arch_id])


def _spec_tree(spec):
    if isinstance(spec, transformer.CacheSpec):
        return (spec.shape, _dtype_name(spec.dtype))
    return {k: _spec_tree(v) for k, v in spec.items()}


@pytest.mark.parametrize("arch_id", sorted(REF_ARCHS))
def test_cache_spec_equals_the_reference(arch_id):
    """Every family's cache tree (K/V rings, conv windows, SSM and LRU
    states, Whisper's cross K/V); abstract, no allocation."""
    cfg = get_config(arch_id)
    ref = ref_model.api(REF_ARCHS[arch_id]).cache_spec(REF_ARCHS[arch_id],
                                                        3, 8192)
    port = model.api(cfg).cache_spec(cfg, 3, 8192)
    want = jax.tree.map(lambda s: (s.shape, np.dtype(s.dtype).name), ref,
                        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    assert _spec_tree(port) == want


def test_init_model_params_matches_param_defs():
    cfg = get_config("starcoder2-3b").reduced()
    defs = model.api(cfg).param_defs(cfg)
    p1 = model.init_model_params(cfg, torch.Generator().manual_seed(3),
                                 device="cpu")
    p2 = model.init_model_params(cfg, torch.Generator().manual_seed(3),
                                 device="cpu")
    for path, d in defs.items():
        a, b = p1, p2
        for k in path:
            a, b = a[k], b[k]
        assert tuple(a.shape) == d.shape, path
        assert a.dtype == (d.dtype or torch.bfloat16), path
        assert torch.equal(a, b), path
        if d.init == "zeros":
            assert not a.any(), path
        elif d.init == "ones":
            assert bool((a == 1).all()), path
    emb = p1["embed"].float()
    # N(0, 1) * scale(): the embedding's std is 1/sqrt(d_model)
    assert abs(float(emb.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05


def test_params_from_numpy_keeps_bits_and_ties():
    host = ref_params(get_config("qwen1.5-0.5b").reduced())
    host["alias"] = host["embed"]
    port = params_from_numpy(host, "cpu")
    assert port["alias"] is port["embed"]
    assert port["embed"].dtype == torch.bfloat16
    assert port["final_norm"]["scale"].dtype == torch.float32
    assert np.array_equal(port["embed"].view(torch.uint16).numpy(),
                          host["embed"].view(np.uint16))
    cache = cache_from_numpy({"pos": np.int32(5)}, "cpu")
    assert cache["pos"].dtype == torch.int32 and int(cache["pos"]) == 5


# ---------------------------------------------------------------------------
# attention (float32 inputs: the algorithm alone)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_chunk,window", [(None, None), (7, None),
                                            (None, 5), (4, 5)])
def test_attention_matches_the_reference(q_chunk, window):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 19, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 19, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 19, 2, 8)).astype(np.float32)
    want = ref_attention.attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   window=window, q_chunk=q_chunk)
    got = attention.attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True,
                              window=window, q_chunk=q_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_decode_attention_matches_the_reference():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    kc = rng.standard_normal((3, 6, 2, 8)).astype(np.float32)
    vc = rng.standard_normal((3, 6, 2, 8)).astype(np.float32)
    lengths = np.array([1, 4, 6], np.int32)
    want = ref_attention.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lengths))
    got = attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# decode, prefill, ring buffers (bf16, the models' own numerics)
# ---------------------------------------------------------------------------

def _decode_lockstep(cfg, n_steps, cache_len, B=2, seed=0):
    """Feed the same tokens through both packages' decode steps; compare
    logits and every K/V cache after each step."""
    rp, pp = pair(cfg, seed)
    rm, pm = ref_model.api(cfg), model.api(cfg)
    rcache = rm.init_cache(cfg, B, cache_len)
    pcache = pm.init_cache(cfg, B, cache_len, device="cpu")
    rstep = ref_serve_step.make_decode_step(cfg)
    pstep = serve_step.make_decode_step(cfg)
    toks = tokens(cfg, (B, n_steps), seed)
    for i in range(n_steps):
        t = toks[:, i:i + 1]
        rlog, rcache = rstep(rp, rcache, jnp.asarray(t))
        plog, pcache = pstep(pp, pcache, torch.from_numpy(t))
        what = f"{cfg.arch_id} step {i}"
        assert plog.dtype == torch.bfloat16 and plog.shape == (B, cfg.vocab)
        assert_close(plog, rlog, what + " logits")
        assert_argmax_agrees(plog, rlog, what + " argmax")
        assert int(pcache["pos"]) == int(rcache["pos"]) == i + 1
        assert pcache["pos"].dtype == torch.int32 and pcache["pos"].ndim == 0
        for li, lc in rcache["layers"].items():
            for kv in ("k", "v"):
                assert_close(pcache["layers"][li][kv], lc[kv],
                             f"{what} layer {li} {kv}")
    return rcache, pcache


@pytest.mark.parametrize("arch_id", DENSE)
def test_decode_step_matches_the_reference(arch_id):
    _decode_lockstep(get_config(arch_id).reduced(), n_steps=12, cache_len=16)


def test_decode_ring_wraps_like_the_reference():
    """More tokens than cache slots: the full-attention cache overwrites
    its oldest slot (`pos % T`), as the reference does."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    rcache, pcache = _decode_lockstep(cfg, n_steps=13, cache_len=8)
    assert int(pcache["pos"]) == 13
    assert pcache["layers"]["0"]["k"].shape[1] == 8


def test_sliding_window_ring_matches_the_reference():
    """starcoder2-3b (LN, GELU, kv=2) with a window shorter than the
    cache: the cache is a ring of `window` slots."""
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              sliding_window=5)
    assert cfg.n_kv_heads == 2 and cfg.norm == "ln" and cfg.mlp == "gelu"
    _, pcache = _decode_lockstep(cfg, n_steps=11, cache_len=16)
    assert pcache["layers"]["1"]["v"].shape[1] == 5


@pytest.mark.parametrize("arch_id,q_chunk", [("qwen1.5-0.5b", None),
                                             ("qwen1.5-0.5b", 5),
                                             ("starcoder2-3b", 4),
                                             ("qwen2.5-14b", 3)])
def test_prefill_and_forward_match_the_reference(arch_id, q_chunk):
    from repro.models import transformer as ref_transformer
    cfg = get_config(arch_id).reduced()
    rp, pp = pair(cfg, seed=1)
    toks = tokens(cfg, (2, 11), seed=1)
    rhid, _ = ref_transformer.forward(rp, jnp.asarray(toks), cfg,
                                      q_chunk=q_chunk)
    phid, paux = transformer.forward(pp, torch.from_numpy(toks), cfg,
                                     q_chunk=q_chunk)
    assert paux == {}
    assert phid.dtype == torch.bfloat16
    assert_close(phid, rhid, f"{arch_id} hidden")
    rlog = ref_serve_step.make_prefill_step(cfg, q_chunk=q_chunk)(
        rp, {"tokens": jnp.asarray(toks)})
    plog = serve_step.make_prefill_step(cfg, q_chunk=q_chunk)(
        pp, {"tokens": torch.from_numpy(toks)})
    assert_close(plog, rlog, f"{arch_id} prefill logits")
    assert_argmax_agrees(plog, rlog, f"{arch_id} prefill argmax")


@pytest.mark.parametrize("arch_id", ["qwen1.5-0.5b", "starcoder2-3b"])
def test_prefill_decode_parity_within_the_port(arch_id):
    """Token-by-token decode reproduces the full forward's last logits,
    with the tolerance of the reference's own parity test."""
    cfg = get_config(arch_id).reduced()
    params = model.init_model_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    m = model.api(cfg)
    toks = torch.from_numpy(tokens(cfg, (2, 7)))
    full, _ = m.prefill(params, {"tokens": toks}, cfg)
    cache = m.init_cache(cfg, 2, 16, device="cpu")
    for i in range(7):
        logits, cache = m.decode_step(params, cache, toks[:, i:i + 1], cfg)
    np.testing.assert_allclose(f32(logits), f32(full), rtol=0.15, atol=0.2)


def test_greedy_generate_matches_the_reference():
    """The port's greedy tokens, fed through the reference's decode step
    (teacher forcing): at every step the reference picks the port's token
    wherever its own top-2 margin exceeds the tolerance."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    rp, pp = pair(cfg, seed=2)
    prompt = tokens(cfg, (2, 5), seed=2)
    got = serve_step.greedy_generate(cfg, pp, torch.from_numpy(prompt),
                                     n_steps=6, cache_len=16)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    got = got.numpy()
    rm = ref_model.api(cfg)
    step = ref_serve_step.make_decode_step(cfg)
    cache = rm.init_cache(cfg, 2, 16)
    for i in range(prompt.shape[1]):
        logits, cache = step(rp, cache, jnp.asarray(prompt[:, i:i + 1]))
    for j in range(got.shape[1]):
        chosen = np.zeros(f32(logits).shape, np.float32)
        chosen[np.arange(2), got[:, j]] = 1.0
        assert_argmax_agrees(chosen, logits, f"generated token {j}")
        logits, cache = step(rp, cache, jnp.asarray(got[:, j:j + 1]))
