"""The port's Whisper encoder-decoder (`repro_torch.models.whisper`) and
the encdec branch of `launch.serve` against the reference, on the CPU,
at the reduced config (1 encoder layer, 16 frames, 2 decoder layers).

Tolerances: the sinusoids on float32 to ``F32`` (`exp`, `sin` and `cos`
within an ulp) for short lengths and to 2.5e-4 absolute at 1,500
positions (see the test); the encoder output, the cross K/V, logits and the
self-attention rings in bf16 to ``TOL`` of `test_torch_models.py`
(absolute and relative 2e-2, about five bf16 ulps at unit scale),
against the reference run op by op.  `serve`'s frames, the
carried parameters and caches are bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as ref_model
from repro.models import whisper as ref_whisper
from repro.train import serve_step as ref_serve_step
from repro_torch.configs import get_config
from repro_torch.models import model, whisper
from repro_torch.models.convert import cache_from_numpy
from repro_torch.train import serve_step
from test_torch_families import F32, bits, t
from test_torch_models import assert_argmax_agrees, assert_close, pair, tokens

ARCH = "whisper-base"


def frames(cfg, B=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, cfg.encoder.n_frames, cfg.d_model))
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("length,channels", [(16, 128), (1500, 512),
                                             (7, 10)])
def test_sinusoids_match_the_reference(length, channels):
    """Equal angles; `sin`/`cos` of float32 angles up to 1,500 rad differ
    between XLA's and torch's range reductions by up to 1.2e-4 (an ulp of
    the angle), a sixtieth of a bf16 ulp at 1, where they are used."""
    want = ref_whisper.sinusoids(length, channels)
    got = whisper.sinusoids(length, channels)
    assert got.dtype == torch.float32
    tol = F32 if length < 100 else dict(rtol=0, atol=2.5e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_encode_and_cross_cache_match_the_reference():
    cfg = get_config(ARCH).reduced()
    rp, pp = pair(cfg)
    rf, pf = frames(cfg)
    renc = ref_whisper.encode(rp, rf, cfg)
    penc = whisper.encode(pp, pf, cfg)
    assert penc.dtype == torch.bfloat16
    assert_close(penc, renc, "encoder output")
    # from the same encoder output, the cross K/V of every layer
    rx = ref_whisper.build_cross_cache(rp, renc, cfg)
    px = whisper.build_cross_cache(pp, t(renc), cfg)
    assert sorted(px) == sorted(rx) == [str(i) for i in range(cfg.n_layers)]
    for i in rx:
        for k in ("xk", "xv"):
            assert px[i][k].shape == rx[i][k].shape
            assert_close(px[i][k], rx[i][k], f"cross {i}/{k}")


def _lockstep(cfg, n_steps, cache_len, B=2):
    """Decode steps of both packages over the same cross K/V (the
    reference's, carried over bit for bit)."""
    rp, pp = pair(cfg)
    rf, _ = frames(cfg, B)
    rcache = ref_model.api(cfg).init_cache(cfg, B, cache_len)
    rcache["cross"] = ref_whisper.build_cross_cache(
        rp, ref_whisper.encode(rp, rf, cfg), cfg)
    pcache = model.api(cfg).init_cache(cfg, B, cache_len, device="cpu")
    assert sorted(pcache["cross"]) == sorted(rcache["cross"])
    pcache["cross"] = cache_from_numpy(
        jax.tree.map(np.asarray, rcache["cross"]), "cpu")
    for i, lc in rcache["cross"].items():
        for k, v in lc.items():                        # carried bit for bit
            assert np.array_equal(bits(pcache["cross"][i][k]), bits(v))
    rstep = ref_serve_step.make_decode_step(cfg)
    pstep = serve_step.make_decode_step(cfg)
    first = {(i, k): v for i, lc in pcache["layers"].items()
             for k, v in lc.items()}
    cross = pcache["cross"]
    toks = tokens(cfg, (B, n_steps))
    for s in range(n_steps):
        tk = toks[:, s:s + 1]
        rlog, rcache = rstep(rp, rcache, jnp.asarray(tk))
        plog, pcache = pstep(pp, pcache, torch.from_numpy(tk))
        what = f"step {s}"
        assert_close(plog, rlog, what + " logits")
        assert_argmax_agrees(plog, rlog, what + " argmax")
        assert int(pcache["pos"]) == s + 1
        assert pcache["cross"] is cross                # never rewritten
        for (i, k), leaf in first.items():
            assert pcache["layers"][i][k] is leaf     # written in place
            assert_close(leaf, rcache["layers"][i][k], f"{what} {i}/{k}")
    return pcache


def test_decode_step_matches_the_reference_past_the_ring():
    cfg = get_config(ARCH).reduced()
    pcache = _lockstep(cfg, n_steps=11, cache_len=8)
    assert pcache["layers"]["0"]["k"].shape[1] == 8


def test_decode_step_makes_no_host_read_of_pos():
    """The step's position is computed from the 0-d ``pos`` tensor: a
    cache whose ``pos`` lives on the meta device runs the step without
    reading a value."""
    cfg = get_config(ARCH).reduced()
    params = model.init_model_params(cfg, torch.Generator().manual_seed(0),
                                     device="meta")
    cache = model.api(cfg).init_cache(cfg, 2, 8, device="meta")
    logits, new = whisper.decode_step(params, cache,
                                      torch.zeros((2, 1), dtype=torch.int32,
                                                  device="meta"), cfg)
    assert logits.shape == (2, cfg.vocab) and new["pos"].device.type == "meta"


@pytest.mark.parametrize("q_chunk", [None, 4])
def test_prefill_and_loss_match_the_reference(q_chunk):
    cfg = get_config(ARCH).reduced()
    rp, pp = pair(cfg, seed=1)
    rf, pf = frames(cfg, seed=1)
    toks = tokens(cfg, (2, 9), seed=1)
    labels = np.roll(toks, -1, axis=1)
    rb = {"frames": rf, "tokens": jnp.asarray(toks),
          "labels": jnp.asarray(labels)}
    pb = {"frames": pf, "tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels)}
    rlog, _ = ref_whisper.prefill(rp, rb, cfg, q_chunk=q_chunk)
    plog, _ = whisper.prefill(pp, pb, cfg, q_chunk=q_chunk)
    assert_close(plog, rlog, "prefill logits")
    assert_argmax_agrees(plog, rlog, "prefill argmax")
    rloss, _ = ref_whisper.loss_fn(rp, rb, cfg, q_chunk=q_chunk, remat=False)
    for remat in (False, True):
        ploss, pmet = whisper.loss_fn(pp, pb, cfg, q_chunk=q_chunk,
                                      remat=remat)
        assert sorted(pmet) == ["nll"]
        np.testing.assert_allclose(float(ploss), float(rloss), rtol=2e-2)


def test_serve_frames_are_bit_equal_to_the_reference(monkeypatch):
    """`serve` draws each session's frames as the reference does (after
    its 8th prompt token, from the same generator) and rounds them as it
    does: float64 -> float32 -> bf16, twice, which is what the
    reference's `jnp.asarray(x, jnp.bfloat16)` does with 64-bit floats
    off (a value just above a bf16 midpoint whose float32 rounding lands
    on it rounds down).  The frames reach `whisper.encode` bit-equal."""
    from repro.launch import serve as ref_serve_mod
    from repro_torch.launch import serve as serve_mod
    seen = {"ref": [], "port": []}
    ref_encode, port_encode = ref_whisper.encode, whisper.encode

    def spy(key, real):
        def encode(params, fr, cfg):
            seen[key].append(np.asarray(fr.view(torch.uint16).numpy()
                                        if key == "port" else
                                        np.asarray(fr).view(np.uint16)))
            return real(params, fr, cfg)
        return encode

    monkeypatch.setattr(ref_whisper, "encode", spy("ref", ref_encode))
    monkeypatch.setattr(whisper, "encode", spy("port", port_encode))
    kw = dict(n_sessions=2, gen_tokens=1, save_every=100, reduced=True,
              log=False, evict_last=False)
    ref_serve_mod.serve(ARCH, **kw)
    serve_mod.serve(ARCH, device="cpu", **kw)
    assert len(seen["port"]) == len(seen["ref"]) == 2
    for got, want in zip(seen["port"], seen["ref"]):
        assert np.array_equal(got.view(np.uint16), want)
    assert not np.array_equal(seen["port"][0], seen["port"][1])
    edge = np.array([1.0 + 2.0 ** -8 + 2.0 ** -30, -3.0 - 2.0 ** -30])
    want = np.asarray(jnp.asarray(edge, jnp.bfloat16)).view(np.uint16)
    got = torch.from_numpy(edge).to(torch.bfloat16)
    assert np.array_equal(got.view(torch.uint16).numpy().view(np.uint16),
                          want)
    assert float(got[0]) == 1.0          # rounded twice, as the reference


def test_params_from_numpy_carries_the_encoder_trees():
    from repro_torch.models.convert import params_from_numpy
    cfg = get_config(ARCH).reduced()
    host = jax.tree.map(np.asarray, ref_model.init_model_params(
        cfg, jax.random.key(3)))
    port = params_from_numpy(host, "cpu")
    assert sorted(port["encoder"]) == sorted(host["encoder"])
    for path in (("encoder", "0", "attn", "wq"), ("enc_final_norm", "scale"),
                 ("layers", "1", "xattn", "bv"), ("frame_proj",)):
        h, p = host, port
        for k in path:
            h, p = h[k], p[k]
        assert np.array_equal(bits(p), bits(h)), path
