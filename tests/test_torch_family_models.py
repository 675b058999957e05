"""The port's other model families as whole models (`repro_torch.models.
transformer` for moe / ssm / hybrid / vlm, and `model.api` for all ten
architectures) against the reference package, on the CPU, at the
reduced configs: decode steps in lockstep past the attention rings,
forward, prefill and loss, and the parameter counts.

Tolerances as in `test_torch_families.py`: logits, hidden states, K/V
rings and float32 recurrent states to ``TOL`` of `test_torch_models.py`
(absolute and relative 2e-2, about five bf16 ulps at unit scale),
against the reference run op by op; losses within 2e-2 relative; the
MoE layers' `expert_counts` and the M-RoPE positions exact; the aux loss
within 1e-5 relative.  The reference's parameters are carried over with
`params_from_numpy`; tokens and patch embeddings come from numpy with a
seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as ref_model
from repro.models import transformer as ref_transformer
from repro.train import serve_step as ref_serve_step
from repro_torch.configs import get_config
from repro_torch.models import model, transformer
from repro_torch.train import serve_step
from test_torch_families import FAMILIES, rand, t
from test_torch_models import assert_argmax_agrees, assert_close, pair, tokens


# ---------------------------------------------------------------------------
# whole families: decode in lockstep, forward / prefill / loss
# ---------------------------------------------------------------------------

def _state_leaves(cache):
    return {(i, k): v for i, lc in cache["layers"].items()
            for k, v in lc.items()}


def _lockstep(cfg, n_steps, cache_len, B=2, seed=0):
    rp, pp = pair(cfg, seed)
    rm, pm = ref_model.api(cfg), model.api(cfg)
    rcache = rm.init_cache(cfg, B, cache_len)
    pcache = pm.init_cache(cfg, B, cache_len, device="cpu")
    rstep = ref_serve_step.make_decode_step(cfg)
    pstep = serve_step.make_decode_step(cfg)
    toks = tokens(cfg, (B, n_steps), seed)
    first = _state_leaves(pcache)
    for i in range(n_steps):
        tk = toks[:, i:i + 1]
        rlog, rcache = rstep(rp, rcache, jnp.asarray(tk))
        plog, pcache = pstep(pp, pcache, torch.from_numpy(tk))
        what = f"{cfg.arch_id} step {i}"
        assert plog.dtype == torch.bfloat16 and plog.shape == (B, cfg.vocab)
        assert_close(plog, rlog, what + " logits")
        assert_argmax_agrees(plog, rlog, what + " argmax")
        assert int(pcache["pos"]) == int(rcache["pos"]) == i + 1
        got = _state_leaves(pcache)
        assert sorted(got) == sorted(_state_leaves(rcache))
        for key, want in _state_leaves(rcache).items():
            assert got[key] is first[key], key       # written in place
            assert got[key].dtype == first[key].dtype
            assert_close(got[key], want, f"{what} {key}")
    return pcache


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_decode_step_matches_the_reference(arch_id):
    """More steps than the attention rings hold (the hybrid's local
    window is 16 slots at the reduced size, the others 8)."""
    cfg = get_config(arch_id).reduced()
    if cfg.family == "hybrid":
        assert cfg.rglru.attn_window == 16
        pcache = _lockstep(cfg, n_steps=20, cache_len=32)
        assert pcache["layers"]["2"]["k"].shape[1] == 16
    else:
        _lockstep(cfg, n_steps=11, cache_len=8)


def _batch(cfg, B=2, S=11, seed=1):
    toks = tokens(cfg, (B, S), seed)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.vlm is not None:
        batch["patch_embeds"] = rand((B, min(cfg.vlm.n_patches, S),
                                      cfg.d_model), seed)
    return batch


@pytest.mark.parametrize("arch_id,q_chunk", [(a, None) for a in FAMILIES]
                         + [("qwen2-vl-2b", 4), ("recurrentgemma-9b", 5)])
def test_forward_prefill_and_loss_match_the_reference(arch_id, q_chunk):
    cfg = get_config(arch_id).reduced()
    rp, pp = pair(cfg, seed=1)
    batch = _batch(cfg, S=20 if cfg.vlm is not None else 11)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: t(v) for k, v in batch.items()}
    rhid, raux = ref_transformer.forward(
        rp, rb["tokens"], cfg, patch_embeds=rb.get("patch_embeds"),
        q_chunk=q_chunk)
    phid, paux = transformer.forward(
        pp, pb["tokens"], cfg, patch_embeds=pb.get("patch_embeds"),
        q_chunk=q_chunk)
    assert_close(phid, rhid, f"{arch_id} hidden")
    assert sorted(paux) == sorted(raux)
    for g, w in zip(paux.get("expert_counts", []),
                    raux.get("expert_counts", [])):
        assert np.array_equal(g.numpy(), np.asarray(w))
    rlog = ref_serve_step.make_prefill_step(cfg, q_chunk=q_chunk)(rp, rb)
    plog = serve_step.make_prefill_step(cfg, q_chunk=q_chunk)(pp, pb)
    assert_close(plog, rlog, f"{arch_id} prefill logits")
    assert_argmax_agrees(plog, rlog, f"{arch_id} prefill argmax")
    rloss, rmet = ref_transformer.loss_fn(rp, rb, cfg, remat=False)
    ploss, pmet = transformer.loss_fn(pp, pb, cfg, remat=True)
    assert sorted(pmet) == sorted(rmet)
    np.testing.assert_allclose(float(ploss), float(rloss), rtol=2e-2)
    np.testing.assert_allclose(float(pmet["nll"]), float(rmet["nll"]),
                               rtol=2e-2)
    if cfg.moe is not None:
        np.testing.assert_allclose(float(pmet["moe_aux"]),
                                   float(rmet["moe_aux"]), rtol=1e-5)
        assert np.array_equal(pmet["expert_counts"].numpy(),
                              np.asarray(rmet["expert_counts"]))


def test_mrope_positions_match_the_reference():
    cfg = get_config("qwen2-vl-2b").reduced()
    for S in (5, 16, 23):
        want = ref_transformer.mrope_positions_for(cfg, 3, S)
        got = transformer.mrope_positions_for(cfg, 3, S)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_vlm_forward_needs_patch_embeds():
    cfg = get_config("qwen2-vl-2b").reduced()
    _, pp = pair(cfg)
    with pytest.raises(ValueError, match="patch_embeds"):
        transformer.forward(pp, torch.zeros((1, 4), dtype=torch.int32), cfg)


@pytest.mark.parametrize("arch_id", FAMILIES + ("whisper-base",))
def test_count_params_matches_the_reference(arch_id):
    cfg = get_config(arch_id)
    for active in (False, True):
        assert model.count_params(cfg, active_only=active) == \
            ref_model.count_params(cfg, active_only=active)


@pytest.mark.parametrize("arch_id", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_cache_from_numpy_carries_recurrent_states(arch_id):
    """A reference cache after 3 steps (float32 SSM / LRU states, bf16
    conv windows and K/V, an int32 ``pos``) comes over bit for bit, and
    the port's next step from it agrees with the reference's."""
    import jax
    from repro_torch.models.convert import cache_from_numpy
    cfg = get_config(arch_id).reduced()
    rp, pp = pair(cfg)
    rstep = ref_serve_step.make_decode_step(cfg)
    rcache = ref_model.api(cfg).init_cache(cfg, 2, 16)
    toks = tokens(cfg, (2, 4))
    for i in range(3):
        _, rcache = rstep(rp, rcache, jnp.asarray(toks[:, i:i + 1]))
    host = jax.tree.map(np.asarray, rcache)
    pcache = cache_from_numpy(host, "cpu")
    assert pcache["pos"].dtype == torch.int32 and int(pcache["pos"]) == 3
    for li, lc in host["layers"].items():
        for k, v in lc.items():
            got = pcache["layers"][li][k]
            if v.dtype.name == "bfloat16":
                assert got.dtype == torch.bfloat16
                assert np.array_equal(got.view(torch.uint16).numpy()
                                      .view(np.uint16), v.view(np.uint16))
            else:
                assert got.dtype == torch.float32 and k in ("ssm", "lru")
                assert np.array_equal(got.numpy(), v)
    rlog, rcache = rstep(rp, rcache, jnp.asarray(toks[:, 3:]))
    plog, pcache = serve_step.make_decode_step(cfg)(
        pp, pcache, torch.from_numpy(toks[:, 3:]))
    assert_close(plog, rlog, f"{arch_id} logits after the carried cache")
