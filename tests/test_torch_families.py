"""The modules of the port's other model families (`repro_torch.models.
{moe,ssm,rglru}`, M-RoPE and `dense`'s promotion in `layers`, the
RG-LRU parts of `transformer`) against the reference package, on the
CPU, at the reduced configs; whole models are in
`test_torch_family_models.py`.

Tolerances:

  * integer routing (`router_dispatch`'s dispatch, combine and the MoE
    layer's `expert_counts`) is exact on equal float32 logits;
  * `linear_scan` is the reference's `associative_scan` in its own order,
    so on equal float32 inputs the scans (`_scan_chunk`,
    `selective_scan`, `rg_lru`, `_rg_lru_blockdiag`) agree to ``SCAN``,
    a few float32 ulps (the products inside `_ssm_coeffs` and the
    C-projection's sums may round in another order);
  * `apply_mrope` on float32 input: ``F32``, within an ulp or two of the
    angles' `cos`/`sin`;
  * bf16 blocks and their decode steps: ``TOL`` of
    `test_torch_models.py` (absolute and relative 2e-2, about five bf16
    ulps at unit scale), against the reference run op by op; recurrent
    states in float32 to the same ``TOL``, since a bf16 ulp upstream
    moves them by that much.

Inputs come from numpy with a seed, and the reference's parameters are
carried over with `params_from_numpy`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import rglru as ref_rglru
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_transformer
from repro_torch.configs import get_config
from repro_torch.models import layers, moe, rglru, ssm, transformer
from repro_torch.models.convert import params_from_numpy
from test_torch_models import assert_close, f32, pair

#: float32 scans on equal inputs (see the module docstring)
SCAN = dict(rtol=2e-5, atol=2e-6)
#: float32 rotary embeddings
F32 = dict(rtol=1e-6, atol=1e-6)

FAMILIES = ("granite-moe-3b-a800m", "kimi-k2-1t-a32b", "falcon-mamba-7b",
            "recurrentgemma-9b", "qwen2-vl-2b")


def t(a) -> torch.Tensor:
    """A numpy array (or a jax array) as a CPU tensor, bf16 kept."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def rand(shape, seed, dtype=np.float32, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(dtype)


def bf16_pair(shape, seed, scale=1.0):
    """The same bf16 values for both packages."""
    x = jnp.asarray(rand(shape, seed, scale=scale), jnp.bfloat16)
    return x, t(x)


def layer_params(cfg, path):
    """Reference and port parameters of one layer's subtree."""
    rp, pp = pair(cfg)
    for k in path:
        rp, pp = rp[k], pp[k]
    return rp, pp


# ---------------------------------------------------------------------------
# layers: M-RoPE and dense's promotion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sections,theta", [((4, 6, 6), 1e4),
                                            ((16, 24, 24), 1e6),
                                            ((2, 1, 5), 500.0)])
def test_apply_mrope_matches_the_reference(sections, theta):
    D = 2 * sum(sections)
    x = rand((2, 9, 3, D), 0)
    pos = np.random.default_rng(1).integers(0, 300, size=(3, 2, 9)) \
        .astype(np.int32)
    want = ref_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                  sections, theta)
    got = layers.apply_mrope(t(x), t(pos), sections, theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    xb, tb = bf16_pair((2, 9, 3, D), 2)
    want = ref_layers.apply_mrope(xb, jnp.asarray(pos), sections, theta)
    got = layers.apply_mrope(tb, t(pos), sections, theta)
    assert got.dtype == torch.bfloat16
    assert_close(got, want, "bf16 mrope")
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(t(x), t(pos), (1, 1, 1), theta)


def test_dense_promotes_mixed_operands_like_einsum():
    """bf16 x float32 is a float32 product (the MoE router); bf16 x bf16
    keeps its bits (the dense family does not move)."""
    xb, tb = bf16_pair((3, 5, 16), 0)
    w32 = rand((16, 7), 1)
    want = ref_layers.dense(xb, jnp.asarray(w32))
    got = layers.dense(tb, t(w32))
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    wb, twb = bf16_pair((16, 7), 1)
    got = layers.dense(tb, twb)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(bits(got), bits(torch.matmul(tb, twb)))


# ---------------------------------------------------------------------------
# MoE: routing exact, the layer within TOL
# ---------------------------------------------------------------------------

def _moe_cfg(X=8, k=2, n_shared=0, cf=1.25):
    return (ref_moe.MoEConfig(n_experts=X, top_k=k, expert_ff=16,
                              n_shared=n_shared, capacity_factor=cf),
            moe.MoEConfig(n_experts=X, top_k=k, expert_ff=16,
                          n_shared=n_shared, capacity_factor=cf))


def _logits(case):
    rng = np.random.default_rng(3)
    # 8 tokens per group: the capacity (8) holds them all
    if case == "random":
        return rng.standard_normal((2, 8, 8)).astype(np.float32)
    if case == "ties":
        # every row holds equal values: ties everywhere, lower index first
        base = rng.integers(0, 3, size=(2, 8, 8)).astype(np.float32)
        base[0, :5] = 1.0
        return base
    # over capacity: nearly every token prefers experts 5 and 2
    lg = rng.standard_normal((2, 40, 8)).astype(np.float32)
    lg[..., 5] += 8.0
    lg[..., 2] += 6.0
    return lg


@pytest.mark.parametrize("case", ["random", "ties", "over_capacity"])
def test_router_dispatch_is_exact(case):
    logits = _logits(case)
    rc, pc = _moe_cfg()
    rd, rcomb, raux = ref_moe.router_dispatch(jnp.asarray(logits), rc)
    pd, pcomb, paux = moe.router_dispatch(t(logits), pc)
    assert pd.dtype == pcomb.dtype == torch.bfloat16
    assert np.array_equal(bits(pd), bits(rd))
    assert np.array_equal(bits(pcomb), bits(rcomb))
    np.testing.assert_allclose(float(paux), float(raux), rtol=1e-6)
    kept = f32(pd).sum(axis=(2, 3))                  # choices kept per token
    C = moe._capacity(logits.shape[1], pc)
    if case == "over_capacity":
        assert (kept < pc.top_k).any()               # some choices dropped
        assert f32(pd).sum(axis=(0, 1, 3)).max() <= 2 * C
    else:
        assert (kept == pc.top_k).all()


def test_top_k_breaks_ties_to_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0]])
    vals, idx = moe.top_k(x, 3)
    assert idx.tolist() == [[1, 2, 4]]
    want = jax.lax.top_k(jnp.asarray(x.numpy()), 3)[1]
    assert idx.numpy().tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_ffn_matches_the_reference(n_shared):
    cfg = get_config("kimi-k2-1t-a32b" if n_shared
                     else "granite-moe-3b-a800m").reduced()
    layer = next(i for i, (_m, f) in enumerate(cfg.layer_plan())
                 if f == "moe")
    rp, pp = layer_params(cfg, ("layers", str(layer), "ffn"))
    rc = ref_transformer._moe_cfg(cfg, 2 * 12)
    pc = transformer._moe_cfg(cfg, 2 * 12)
    # the reference's config also names the experts' sharding axis
    assert {k: v for k, v in dataclasses.asdict(rc).items()
            if k != "ep_logical"} == dataclasses.asdict(pc)
    xb, tb = bf16_pair((2, 12, cfg.d_model), 5)
    ry, raux, rcounts = ref_moe.moe_ffn(xb, rp, rc)
    py, paux, pcounts = moe.moe_ffn(tb, pp, pc)
    assert py.dtype == torch.bfloat16
    assert_close(py, ry, "moe_ffn y")
    np.testing.assert_allclose(float(paux), float(raux), rtol=1e-6)
    assert pcounts.dtype == torch.float32
    assert np.array_equal(pcounts.numpy(), np.asarray(rcounts))
    assert pcounts.sum() > 0


# ---------------------------------------------------------------------------
# scans (float32, equal inputs)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 13, 64])
def test_linear_scan_matches_associative_scan(n):
    a = np.random.default_rng(n).uniform(0.5, 1.0, (2, n, 5)) \
        .astype(np.float32)
    b = rand((2, n, 5), n + 1)

    def combine(c1, c2):
        return c2[0] * c1[0], c2[0] * c1[1] + c2[1]

    wa, wb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ga, gb = ssm.linear_scan(t(a), t(b), dim=1)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **SCAN)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **SCAN)
    # and it is the recurrence h_t = a_t h_{t-1} + b_t
    h, seq = np.zeros((2, 5), np.float64), []
    for i in range(n):
        h = a[:, i] * h + b[:, i]
        seq.append(h)
    np.testing.assert_allclose(gb.numpy(), np.stack(seq, 1), rtol=1e-4,
                               atol=1e-5)


def _ssm_pair():
    cfg = get_config("falcon-mamba-7b").reduced()
    rp, pp = layer_params(cfg, ("layers", "0", "mamba"))
    return cfg, rp, pp


def test_scan_chunk_matches_the_reference():
    rng = np.random.default_rng(7)
    Abar = rng.uniform(0.3, 1.0, (2, 8, 6, 4)).astype(np.float32)
    Bx = rand((2, 8, 6, 4), 8)
    h0 = rand((2, 6, 4), 9)
    rh, rlast = ref_ssm._scan_chunk(jnp.asarray(Abar), jnp.asarray(Bx),
                                    jnp.asarray(h0))
    ph, plast = ssm._scan_chunk(t(Abar), t(Bx), t(h0))
    np.testing.assert_allclose(ph.numpy(), np.asarray(rh), **SCAN)
    np.testing.assert_allclose(plast.numpy(), np.asarray(rlast), **SCAN)


@pytest.mark.parametrize("L,chunk", [(8, 8), (16, 8), (13, 8), (5, 8),
                                     (24, 4)])
def test_selective_scan_matches_the_reference(L, chunk):
    """One chunk, several, a padded last chunk, a sequence shorter than a
    chunk; float32 input, so the scan alone is compared."""
    cfg = get_config("falcon-mamba-7b").reduced()
    _, rp, pp = _ssm_pair()
    scfg = ref_transformer._ssm_cfg(cfg)
    scfg = dataclasses.replace(scfg, chunk=chunk)
    pcfg = dataclasses.replace(transformer._ssm_cfg(cfg), chunk=chunk)
    x = rand((2, L, scfg.d_inner), 11, scale=0.5)
    rp32 = {k: jnp.asarray(np.asarray(v).astype(np.float32))
            for k, v in rp.items()}
    pp32 = {k: v.float() for k, v in pp.items()}
    want = ref_ssm.selective_scan(rp32, jnp.asarray(x), scfg)
    got = ssm.selective_scan(pp32, t(x), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)


def test_causal_conv1d_matches_the_reference():
    w, tw = bf16_pair((4, 24), 1, scale=0.5)
    b, tb = bf16_pair((24,), 2)
    x, tx = bf16_pair((2, 9, 24), 3)
    want = ref_ssm.causal_conv1d(x, w, b)
    got = ssm.causal_conv1d(tx, tw, tb)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(bits(got), bits(want))


def test_rg_lru_matches_the_reference():
    """The dense-gate RG-LRU of `rglru.py` (which `transformer` does not
    call) and the block-diagonal one of `transformer`, float32."""
    W = 16
    p = {"w_a": rand((W, W), 1, scale=0.3), "w_x": rand((W, W), 2, scale=0.3),
         "lambda": rand((W,), 3)}
    x = rand((2, 11, W), 4)
    want = ref_rglru.rg_lru({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x))
    got = rglru.rg_lru({k: t(v) for k, v in p.items()}, t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)
    bd = {"w_a": rand((4, 4, 4), 5, scale=0.5),
          "w_x": rand((4, 4, 4), 6, scale=0.5), "lambda": rand((W,), 7)}
    want = ref_transformer._rg_lru_blockdiag(
        {k: jnp.asarray(v) for k, v in bd.items()}, jnp.asarray(x))
    got = transformer._rg_lru_blockdiag(
        {"gate_a": t(bd["w_a"]), "gate_x": t(bd["w_x"]),
         "lambda": t(bd["lambda"])}, t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)
    # one step from a state equals the scan's next position
    state = rand((2, W), 8)
    want_y, want_s = ref_rglru.rg_lru_decode_step(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x[:, :1]),
        jnp.asarray(state))
    got_y, got_s = rglru.rg_lru_decode_step(
        {k: t(v) for k, v in p.items()}, t(x[:, :1]), t(state))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **SCAN)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **SCAN)


# ---------------------------------------------------------------------------
# bf16 blocks and their decode steps
# ---------------------------------------------------------------------------

def test_mamba_block_and_decode_step_match_the_reference():
    cfg, rp, pp = _ssm_pair()
    rc, pc = ref_transformer._ssm_cfg(cfg), transformer._ssm_cfg(cfg)
    x, tx = bf16_pair((2, 13, cfg.d_model), 1)
    assert_close(ssm.mamba_block(pp, tx, pc),
                 ref_ssm.mamba_block(rp, x, rc), "mamba_block")
    conv, tconv = bf16_pair((2, rc.d_conv - 1, rc.d_inner), 2)
    state = rand((2, rc.d_inner, rc.d_state), 3)
    ry, rconv, rstate = ref_ssm.mamba_decode_step(
        rp, x[:, :1], conv, jnp.asarray(state), rc)
    py, pconv, pstate = ssm.mamba_decode_step(pp, tx[:, :1], tconv,
                                              t(state), pc)
    assert_close(py, ry, "mamba decode y")
    assert np.array_equal(bits(pconv), bits(rconv))
    assert_close(pstate, rstate, "mamba decode state")
    assert np.array_equal(bits(tconv), bits(conv))      # inputs not written


def test_recurrent_block_and_decode_match_the_reference():
    """`rglru.recurrent_block` and its decode step (dense gates) and
    `transformer`'s block-diagonal form, in bf16."""
    W = 32
    rng_p = {"in_gate": rand((W, W), 1, scale=W ** -0.5),
             "in_rec": rand((W, W), 2, scale=W ** -0.5),
             "conv_w": rand((4, W), 3, scale=0.5), "conv_b": rand((W,), 4),
             "w_a": rand((W, W), 5, scale=W ** -0.5),
             "w_x": rand((W, W), 6, scale=W ** -0.5),
             "out_proj": rand((W, W), 7, scale=W ** -0.5)}
    rp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in rng_p.items()}
    rp["lambda"] = jnp.asarray(rand((W,), 8))
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    rc = ref_rglru.RGLRUConfig(lru_width=W)
    pc = rglru.RGLRUConfig(lru_width=W)
    x, tx = bf16_pair((2, 9, W), 9)
    assert_close(rglru.recurrent_block(pp, tx, pc),
                 ref_rglru.recurrent_block(rp, x, rc), "recurrent_block")
    conv, tconv = bf16_pair((2, 3, W), 10)
    state = rand((2, W), 11)
    ry, rconv, rs = ref_rglru.recurrent_block_decode(
        rp, x[:, :1], conv, jnp.asarray(state), rc)
    py, pconv, ps = rglru.recurrent_block_decode(pp, tx[:, :1], tconv,
                                                 t(state), pc)
    assert_close(py, ry, "recurrent decode y")
    assert np.array_equal(bits(pconv), bits(rconv))
    assert_close(ps, rs, "recurrent decode state")
    cfg = get_config("recurrentgemma-9b").reduced()
    rp, pp = layer_params(cfg, ("layers", "0", "rec"))
    x, tx = bf16_pair((2, 9, cfg.d_model), 12)
    assert_close(transformer._recurrent_apply(pp, tx, cfg),
                 ref_transformer._recurrent_apply(rp, x, cfg),
                 "blockdiag recurrent block")
