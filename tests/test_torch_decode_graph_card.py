"""The compiled decode step (`repro_torch.train.serve_step.
compile_decode_step`) on a card, at the reduced configs of every family
`serve` takes: the capture leaves the session's cache bit-equal, and the
graph replays the eager step.

This file imports no JAX and nothing of the reference, so it runs where
the card is: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_decode_graph_card.py``.  Without a card every test
skips through the `cuda` fixture; the graph's body, which the CPU runs
eagerly, is held against the reference in `test_torch_decode_graph.py`.

Tolerance: bit-equal wherever two eager runs of the same step are
bit-equal to each other; where they are not (a kernel that sums in a
run-dependent order), every element within ``TOL_ALL`` (absolute and
relative 4e-2) and at least ``TOL_SHARE`` (99.9%) of each tensor within
``TOL`` (2e-2), the rule `chip_smoke.py` phase 11a holds the card to.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import model, whisper
from repro_torch.train import serve_step
from repro_torch.train.tree import tree_map

#: every family `serve` takes
SERVED = ("qwen1.5-0.5b", "granite-moe-3b-a800m", "falcon-mamba-7b",
          "recurrentgemma-9b", "whisper-base", "qwen2-vl-2b")
TOL = dict(rtol=2e-2, atol=2e-2)
TOL_ALL = dict(rtol=4e-2, atol=4e-2)
TOL_SHARE = 0.999
B, T, STEPS = 2, 8, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode (its "
                    "body is tested in test_torch_decode_graph.py)")
    return torch.device("cuda")


def leaves(cache):
    return {(i, k): v for i, lc in cache["layers"].items()
            for k, v in lc.items()}


def assert_near(got, want, what):
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.allclose(got, want, **TOL_ALL), what
    share = float(torch.isclose(got, want, **TOL).float().mean())
    assert share >= TOL_SHARE, f"{what}: {share:.5f} within {TOL}"


@pytest.mark.parametrize("arch_id", SERVED)
def test_capture_leaves_the_cache_and_replays_the_eager_step(cuda, arch_id):
    """The cache (random values) is bit-equal after `compile_decode_step`
    to what it was before; then 8 replays against the eager step on two
    copies of the cache, with equal tokens: logits, ``pos`` and every
    cache leaf bit-equal to the first copy where the two eager runs are
    bit-equal, else within the module's rule."""
    cfg = get_config(arch_id).reduced()
    m = model.api(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model.init_model_params(cfg, gen, device=cuda)
    cache = m.init_cache(cfg, B, T, device=cuda)
    for t in leaves(cache).values():
        t.normal_(generator=gen)
    rng = np.random.default_rng(0)
    if cfg.encoder is not None:
        frames = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model))).to(torch.bfloat16)
        cache["cross"] = whisper.build_cross_cache(
            params, whisper.encode(params, frames.to(cuda), cfg), cfg)
    copies = [tree_map(torch.clone, cache) for _ in range(2)]
    before = tree_map(torch.clone, cache)
    torch.cuda.set_sync_debug_mode("error")    # no host sync in the step
    try:
        step = serve_step.compile_decode_step(cfg, params, cache,
                                              device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert step.graph is not None
    assert torch.equal(step.cache["pos"], before["pos"])
    for key, leaf in leaves(before).items():
        assert torch.equal(leaves(step.cache)[key], leaf), key
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, STEPS))
                            .astype(np.int32)).to(cuda)
    for i in range(STEPS):
        tk = toks[:, i:i + 1]
        outs = []
        for j, c in enumerate(copies):
            lg, copies[j] = m.decode_step(params, c, tk, cfg)
            outs.append(lg)
        got, cache = step(tk)
        assert cache is step.cache and int(cache["pos"]) == i + 1
        pairs = [(got, outs[0], outs[1], "logits"),
                 (cache["pos"], copies[0]["pos"], copies[1]["pos"], "pos")]
        pairs += [(leaves(cache)[k], v, leaves(copies[1])[k], str(k))
                  for k, v in leaves(copies[0]).items()]
        stable = all(torch.equal(a, b) for _, a, b, _ in pairs)
        for g, w, _, what in pairs:
            what = f"{arch_id} step {i} {what}"
            if stable:
                assert torch.equal(g, w), what
            else:
                assert_near(g, w, what)


def test_capture_raises_on_a_host_sync(cuda, monkeypatch):
    """A step that syncs with the host cannot be captured: the capture
    raises, and nothing runs the step eagerly in its place."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    m = model.api(cfg)
    params = model.init_model_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    cache = m.init_cache(cfg, B, T, device=cuda)
    real = m.decode_step

    def syncing(params, cache, tokens, cfg):
        logits, out = real(params, cache, tokens, cfg)
        float(logits[0, 0])                      # a device->host read
        return logits, out

    monkeypatch.setattr(model.transformer, "decode_step", syncing)
    with pytest.raises(RuntimeError):
        serve_step.compile_decode_step(cfg, params, cache, device=cuda)
    assert int(cache["pos"]) == 0
