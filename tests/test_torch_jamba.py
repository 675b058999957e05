"""AI21-Jamba2-Mini in the port (`configs.JambaConfig`: Mamba-1 with its
dt, B and C norms, attention without a positional encoding, a router
that does not renormalise its top-2 and an expert layer told which
experts it holds) against the benchmark's plain float32 reference
(`chipbench/reference/jamba.py`), and that reference against Hugging
Face's `JambaForCausalLM`, on the CPU at a tiny size with seeded random
weights.  Neither side imports JAX: the JAX package has no Jamba.

Tolerances, each with its reason:

- ``LOGIT_TOL`` = 0.06, on the median over positions of the distance
  between the port's logits and the reference's, as a share of the
  reference's (L2 over the vocabulary; the benchmark's ``logit_err``).
  The port rounds every activation to bfloat16 and the reference keeps
  float32: over one 8-layer period that reads 0.023-0.034 (seeds 0-3),
  and the reference itself in float8 reads 0.25-0.29, so the limit lies
  between with room on both sides.  The median and not the largest:
  where two experts' router scores lie within rounding of each other a
  token's choice flips, and with it that position's logits.
- ``SHARE_TOL`` = 2e-2, relative, on the sum of the port's two expert
  shares against the uncut reference layer: one bfloat16 layer's
  rounding (about five ulps); the reference's own shares add up to
  float32 rounding (1e-5).
- ``HF_TOL`` = 1e-4, relative, on the reference against
  `JambaForCausalLM`, both in float32: only the order of float sums
  differs; bfloat16 anywhere reads ~1e-2.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from chipbench.drivers.hybrid_session_loop import arch_config  # noqa: E402
from chipbench.reference import jamba as ref  # noqa: E402
from repro_torch.configs import (ARCHS, PORT_ARCHS, ArchConfig,  # noqa: E402
                                 JambaConfig, get_config)
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.models.model import api, count_params  # noqa: E402
from repro_torch.parallel.sharding import placements_for, spec_for  # noqa
from repro_torch.train.serve_step import compile_decode_step  # noqa: E402

LOGIT_TOL = 0.06
SHARE_TOL = 2e-2
HF_TOL = 1e-4
CONFIG = REPO / "chipbench" / "configs" / "ai21-jamba2-mini.ep2.json"
#: one whole 8-layer period at a tiny width; 8 routed experts, 4 held
TINY = {"hidden_size": 64, "num_hidden_layers": 8, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 32,
        "vocab_size": 512, "mamba_dt_rank": 8, "mamba_d_state": 4,
        "num_experts": 8}


def tiny_file(held=(0, 4)) -> dict:
    cfg = json.loads(CONFIG.read_text())
    cfg.update(TINY)
    cfg["expert_parallel"] = dict(cfg["expert_parallel"],
                                  first_expert_held=held[0],
                                  experts_held=held[1])
    return cfg


def tiny(seed: int, held=(0, 4)):
    """(reference shape, port config, parameters) from `seed`."""
    cfg = tiny_file(held)
    s = ref.Shape.of(cfg)
    return s, arch_config(cfg), ref.make_params(s, seed, "cpu")


def rel(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    return (torch.linalg.vector_norm(got.float() - want, dim=-1)
            / torch.linalg.vector_norm(want, dim=-1))


def tokens(s, shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, s.V, shape, generator=g)


# -- the configuration -------------------------------------------------------

def test_the_published_layout_and_the_chips_share():
    cfg = get_config("ai21-jamba2-mini")
    plan = cfg.layer_plan()
    assert [i for i, (m, _) in enumerate(plan) if m == "attn"] == \
        [4, 12, 20, 28]
    assert all(m == "mamba" for i, (m, _) in enumerate(plan)
               if i not in (4, 12, 20, 28))
    assert [f for _, f in plan] == ["swiglu", "moe"] * 16
    assert cfg.held_experts() == (0, 8)
    defs = api(cfg).param_defs(cfg)
    assert defs[("layers", "1", "ffn", "router")].shape == (4096, 16)
    assert defs[("layers", "1", "ffn", "w_gate")].shape == (8, 4096, 14336)
    assert defs[("layers", "0", "mamba", "dt_norm")].shape == (256,)
    assert ("layers", "4", "attn", "bq") not in defs
    # 29.0 B parameters here of the published 51.6 B (52B-A12B)
    assert count_params(cfg) == 29_021_745_024
    spec = transformer.cache_spec(cfg, 4, 128)
    nbytes = {k: sum(math.prod(v[k].shape) * v[k].dtype.itemsize
                     for v in spec["layers"].values() if k in v)
              for k in ("conv", "ssm", "k", "v")}
    assert nbytes["conv"] + nbytes["ssm"] == 64_225_280       # 64.2 MB
    assert nbytes["k"] + nbytes["v"] == 8_388_608             # 8.4 MB
    # the file's sizes give the port's own configuration back
    assert arch_config(json.loads(CONFIG.read_text())) == cfg


def test_the_registry_keeps_the_reference_ids_and_the_family_flags():
    assert "ai21-jamba2-mini" in PORT_ARCHS
    assert "ai21-jamba2-mini" not in ARCHS
    for cfg in ARCHS.values():
        assert type(cfg) is ArchConfig
        assert (cfg.rope, cfg.embed_scale, cfg.ssm_inner_norms,
                cfg.router_renormalize, cfg.held_experts()) == \
            (True, True, False, True, None)
        for flag in ("rope", "embed_scale", "ssm_inner_norms",
                     "router_renormalize"):
            assert flag not in dataclasses.asdict(cfg)
    r = get_config("ai21-jamba2-mini").reduced()
    assert isinstance(r, JambaConfig) and r.n_layers == 8
    assert r.moe.n_experts == 8 and r.held_experts() == (0, 4)
    assert r.n_kv_heads < r.n_heads
    assert {m for m, _ in r.layer_plan()} == {"attn", "mamba"}


def test_every_leaf_has_a_sharding_spec():
    """The new leaves (the held experts, the Mamba norms) take the
    existing logical axes, so the rules cover them on every mesh."""
    cfg = get_config("ai21-jamba2-mini")
    defs = api(cfg).param_defs(cfg)
    axes = transformer.cache_axes(cfg)
    spec = transformer.cache_spec(cfg, 128, 32768)
    leaves = [(d.axes, d.shape) for d in defs.values()]
    leaves += [(axes["layers"][i][k], spec["layers"][i][k].shape)
               for i in axes["layers"] for k in axes["layers"][i]]

    class Mesh:
        def __init__(self, shape):
            self.shape = shape

    for shape in ({"data": 16, "model": 16},
                  {"pod": 2, "data": 16, "model": 16}, {"model": 2}):
        m = Mesh(shape)
        for ax, shp in leaves:
            placements_for(m, spec_for(m, ax, tuple(shp)))


# -- the port against the plain reference -------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_forward_agrees_with_the_reference(seed):
    s, cfg, params = tiny(seed)
    tok = tokens(s, (3, 16), seed)
    with torch.no_grad():
        want = ref.forward(params, tok, s)
        x, _ = transformer.forward(params, tok, cfg)
        got = transformer.logits_from(params, x, cfg)
        fp8 = ref.forward(params, tok, s, ref.FP8_CONTROL)
    assert float(rel(got, want).median()) <= LOGIT_TOL
    # the limit fails the control computed in float8
    assert float(rel(fp8, want).median()) > 2 * LOGIT_TOL


def test_prefill_then_decode_through_the_cache_agrees_with_the_forward():
    """The prompt fed through the compiled decode step (the serving
    path's prefill), then greedy tokens, against the reference's full
    forward over the same tokens; a second sequence from position 0 in
    the same cache reads the same logits bit for bit."""
    s, cfg, params = tiny(2)
    m = api(cfg)
    prompt, gen = tokens(s, (3, 6), 2), 10
    cache = m.init_cache(cfg, 3, 32, device="cpu")
    step = compile_decode_step(cfg, params, cache, device="cpu")

    def serve():
        seq, out = [prompt[:, i:i + 1] for i in range(prompt.shape[1])], []
        for i in range(prompt.shape[1] + gen - 1):
            logits, _ = step(seq[i].to(torch.int32))
            out.append(logits.float().clone())
            if i >= prompt.shape[1] - 1:
                seq.append(logits.argmax(-1, keepdim=True))
        return torch.cat(seq, 1), torch.stack(out, 1)

    seq, got = serve()
    with torch.no_grad():
        want = ref.forward(params, seq[:, :-1], s)
    assert float(rel(got, want).median()) <= LOGIT_TOL
    step.cache["pos"].zero_()
    seq2, got2 = serve()
    assert torch.equal(seq2, seq) and torch.equal(got2, got)


def test_expert_shares_add_up_to_the_uncut_layer():
    """Experts 0-3 and 4-7 of a layer of 8, each a chip's share, add up
    to the uncut layer: what every chip computes alike (attention,
    Mamba, the dense FFNs) is not part of the sum."""
    s, _, full = tiny(3, held=(0, 8))
    h = torch.randn(2, 5, s.E, generator=torch.Generator().manual_seed(3))
    f = full["layers"]["1"]["ffn"]

    def share(lo, n):
        return {"router": f["router"],
                **{w: f[w][lo:lo + n] for w in ("w_gate", "w_up",
                                                "w_down")}}

    with torch.no_grad():
        uncut = ref.experts(h, f, s, ref.F32_REF)
        parts = [ref.experts(h, share(lo, 4),
                             dataclasses.replace(s, held=(lo, 4)),
                             ref.F32_REF) for lo in (0, 4)]
        torch.testing.assert_close(parts[0] + parts[1], uncut, rtol=1e-5,
                                   atol=1e-5)
        port = []
        for lo in (0, 4):
            c = moe.MoEConfig(n_experts=8, top_k=2, expert_ff=s.F,
                              n_groups=1)
            y, _, counts = moe.moe_ffn(h.bfloat16(), share(lo, 4), c,
                                       held=(lo, 4), renormalize=False)
            assert counts.shape == (4,)
            port.append(y.float())
    assert float(rel(port[0] + port[1], uncut).max()) <= SHARE_TOL
    # each share is a part, not the whole
    for part in port:
        assert float(rel(part.flatten(), uncut.flatten())) > SHARE_TOL


# -- the reference against Hugging Face's Jamba -------------------------------

def test_the_reference_agrees_with_hugging_face_jamba():
    transformers = pytest.importorskip("transformers")
    s, _, p = tiny(4, held=(0, 8))
    hf_cfg = transformers.JambaConfig(
        vocab_size=s.V, hidden_size=s.E, intermediate_size=s.F,
        num_hidden_layers=s.L, num_attention_heads=s.Hq,
        num_key_value_heads=s.Hkv, num_experts=s.routed,
        num_experts_per_tok=s.top_k, attn_layer_period=s.attn_period,
        attn_layer_offset=s.attn_offset, expert_layer_period=s.expert_period,
        expert_layer_offset=s.expert_offset, mamba_d_state=s.N,
        mamba_d_conv=s.K, mamba_expand=s.Ei // s.E, mamba_dt_rank=s.R,
        mamba_conv_bias=True, mamba_proj_bias=False, rms_norm_eps=s.eps,
        use_mamba_kernels=False, tie_word_embeddings=False,
        attn_implementation="eager")
    hf = transformers.JambaForCausalLM(hf_cfg).float().eval()

    def t(x):
        return x.float().T.contiguous()

    def norm(x):
        return 1.0 + x.float()

    w = {"model.embed_tokens.weight": p["embed"].float(),
         "lm_head.weight": t(p["lm_head"]),
         "model.final_layernorm.weight": norm(p["final_norm"]["scale"])}
    for i in range(s.L):
        lp, h = p["layers"][str(i)], f"model.layers.{i}."
        w[h + "input_layernorm.weight"] = norm(lp["norm1"]["scale"])
        w[h + "pre_ff_layernorm.weight"] = norm(lp["norm2"]["scale"])
        if s.attention(i):
            for a in "qkvo":
                w[h + f"self_attn.{a}_proj.weight"] = t(lp["attn"][f"w{a}"])
        else:
            mb, hm = lp["mamba"], h + "mamba."
            w.update({hm + "in_proj.weight": t(mb["in_proj"]),
                      hm + "conv1d.weight": t(mb["conv_w"])[:, None, :],
                      hm + "conv1d.bias": mb["conv_b"].float(),
                      hm + "x_proj.weight": t(mb["x_proj"]),
                      hm + "dt_proj.weight": t(mb["dt_proj"]),
                      hm + "dt_proj.bias": mb["dt_bias"].float(),
                      hm + "A_log": mb["A_log"].float(),
                      hm + "D": mb["D"].float(),
                      hm + "out_proj.weight": t(mb["out_proj"]),
                      hm + "dt_layernorm.weight": norm(mb["dt_norm"]),
                      hm + "b_layernorm.weight": norm(mb["b_norm"]),
                      hm + "c_layernorm.weight": norm(mb["c_norm"])})
        f, hf_ = lp["ffn"], h + "feed_forward."
        if s.experts(i):
            w[hf_ + "router.weight"] = t(f["router"])
            for e in range(s.routed):
                for a, b in (("gate", "w_gate"), ("up", "w_up"),
                             ("down", "w_down")):
                    w[hf_ + f"experts.{e}.{a}_proj.weight"] = t(f[b][e])
        else:
            for a, b in (("gate", "w_gate"), ("up", "w_up"),
                         ("down", "w_down")):
                w[hf_ + f"{a}_proj.weight"] = t(f[b])
    missing, unexpected = hf.load_state_dict(w, strict=False)
    assert not missing and not unexpected
    tok = tokens(s, (2, 12), 4)
    with torch.no_grad():
        want = hf(input_ids=tok, use_cache=False).logits
        got = ref.forward(p, tok, s)
    assert float(rel(got, want).max()) <= HF_TOL
