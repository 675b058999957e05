"""The port's training slice (`repro_torch.train`, `launch.train`,
`runtime`) vs the reference package, on the CPU.

The data pipeline, `touched_prefixes_from_metrics`, the straggler monitor
and the supervisor's restart bookkeeping are exact.  Float numerics are
held to tolerances stated beside each test:

  * optimizers on identical float32 grads and params: optimizer state
    within 1e-6 relative (the same float32 ops; Adafactor's means may sum
    in another order), new bf16 params at most 1 bf16 ulp off and equal
    in >= 99.9% of elements (a last-bit difference of `pow` in the bias
    correction can flip a rounding);
  * a train step against the reference's step run op by op (not under
    `jax.jit`, which fuses bf16 chains; see `test_torch_models.py`), from
    the same parameters (`train_state_from_numpy`): loss and grad norm
    within 2e-2 relative, new params within 2 * lr + 1 bf16 ulp
    elementwise.  AdamW's first step moves a parameter by about
    lr * sign(g), so a gradient whose bf16 rounding (or sign, near zero)
    differs between XLA and torch moves it by up to 2 * lr;
  * whole training runs: losses within 2e-2 relative; stores, leaf
    paths, counts and cursors equal, and stores written by either package
    load bit-exact in the other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import Chipmink as RefChipmink
from repro.core import FileStore as RefFileStore
from repro.core import RetryPolicy as RefRetryPolicy
from repro.core.faults import FaultyStore as RefFaultyStore
from repro.launch import train as ref_train
from repro.models.model import init_model_params as ref_init_params
from repro.runtime.fault_tolerance import StragglerMonitor as RefMonitor
from repro.runtime.fault_tolerance import TrainingSupervisor as RefSupervisor
from repro.train import data as ref_data
from repro.train import grad_compress as ref_gc
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch.configs import get_config
from repro_torch.core import Chipmink, FileStore, LGA, MemoryStore, RetryPolicy
from repro_torch.core.faults import FaultyStore
from repro_torch.launch import train as port_train
from repro_torch.models.convert import params_from_numpy, train_state_from_numpy
from repro_torch.models.layers import round_to
from repro_torch.runtime import StragglerMonitor, TrainingSupervisor
from repro_torch.train import data, grad_compress, optimizer, train_step

DENSE = ("qwen1.5-0.5b", "qwen2.5-14b", "starcoder2-3b", "starcoder2-7b")
#: the other families
FAMILIES = ("granite-moe-3b-a800m", "kimi-k2-1t-a32b", "falcon-mamba-7b",
            "recurrentgemma-9b", "qwen2-vl-2b", "whisper-base")
LR = 1e-3
#: loss, grad norm and whole-run losses, relative
RTOL_LOSS = 2e-2


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def bits(x) -> np.ndarray:
    """Raw bytes of a leaf (bf16 through its uint16 bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.uint16)
        return x.contiguous().numpy().reshape(-1).view(np.uint8)
    a = np.asarray(x)
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def leaves_by_path(tree, pre=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves_by_path(tree[k], pre + (k,)))
        return out
    return {"/".join(pre): tree}


def assert_trees_bit_equal(got, want):
    """Equal paths and leaf bytes; a step counter (a Python int once
    saved) compares by value."""
    g, w = leaves_by_path(got), leaves_by_path(want)
    assert sorted(g) == sorted(w)
    for path in w:
        if path == "step":
            assert int(g[path]) == int(w[path])
        else:
            assert np.array_equal(bits(g[path]), bits(w[path])), path


def capture_readonly(mp, module):
    """Record what `module.readonly_state_leaves` returns."""
    seen = []
    real = module.readonly_state_leaves

    def wrapped(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    mp.setattr(module, "readonly_state_leaves", wrapped)
    return seen


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def assert_params_within(got, want, lr=LR, what=""):
    """Elementwise |got - want| <= 2 * lr + 1 bf16 ulp."""
    g, w = leaves_by_path(got), leaves_by_path(want)
    assert sorted(g) == sorted(w)
    for path in w:
        a, b = f32(w[path]), f32(g[path])
        assert a.shape == b.shape, path
        tol = 2 * lr + bf16_ulp(np.maximum(np.abs(a), np.abs(b)))
        assert (np.abs(a - b) <= tol).all(), \
            f"{what} {path}: max excess {np.max(np.abs(a - b) - tol)}"


def ref_state_np(cfg, opt_cfg, seed=0, grad_compress=False):
    params = ref_init_params(cfg, jax.random.key(seed))
    state = ref_ts.init_train_state(cfg, params, opt_cfg,
                                    grad_compress=grad_compress)
    return jax.tree.map(np.asarray, state)


def batch_np(cfg, B=2, S=16, seed=0):
    """Tokens and labels, and the stub frontends' float32 inputs where the
    family has one (both packages round them to bf16 alike).  A VLM
    sequence holds its patches and then 8 text tokens: with patches alone
    every position's temporal M-RoPE stream is 0, a key bias then shifts
    every score of a query alike in those lanes, and its gradient there is
    0 but for rounding; with 8 text tokens the angles stay small enough
    that it still cancels to a few ulps of its terms."""
    if cfg.vlm is not None:
        S = max(S, cfg.vlm.n_patches + 16)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.vlm is not None:
        batch["patch_embeds"] = rng.standard_normal(
            (B, min(cfg.vlm.n_patches, S), cfg.d_model)).astype(np.float32)
    if cfg.encoder is not None:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# data pipeline (exact)
# ---------------------------------------------------------------------------

def test_token_pipeline_is_bit_equal_to_the_reference():
    for host in range(2):
        ref = ref_data.TokenPipeline(512, 8, 16, seed=3, host_index=host,
                                     host_count=2)
        port = data.TokenPipeline(512, 8, 16, seed=3, host_index=host,
                                  host_count=2)
        for _ in range(5):
            r, p = ref.next_batch(), port.next_batch()
            assert sorted(r) == sorted(p)
            for k in r:
                assert r[k].dtype == p[k].dtype and np.array_equal(r[k], p[k])
            assert ref.cursor() == port.cursor()
        cursor = dict(port.cursor(), step=2)
        ref.restore(cursor)
        port.restore(cursor)
        assert ref.local_batch == port.local_batch == 4
        r, p = ref.next_batch(), port.next_batch()
        assert all(np.array_equal(r[k], p[k]) for k in r)
        assert ref.cursor() == port.cursor() == dict(cursor, step=3)


# ---------------------------------------------------------------------------
# optimizers and gradient compression
# ---------------------------------------------------------------------------

def _opt_params(rng):
    """bf16 factored (2-D, 3-D) and unfactored (1-D) leaves, a float32
    (n, 1) leaf (unfactored: its last dim is 1)."""
    return {
        "a": rng.standard_normal((64, 32)).astype(np.float32),
        "b": rng.standard_normal((16,)).astype(np.float32),
        "c": rng.standard_normal((8, 1)).astype(np.float32),
        "d": {"e": rng.standard_normal((4, 8, 16)).astype(np.float32)},
    }


BF16_LEAVES = ("a", "b", "d/e")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_match_the_reference(name):
    rng = np.random.default_rng(1)
    cfg_r = ref_opt.OptConfig(name=name, lr=1e-2)
    cfg_p = optimizer.OptConfig(name=name, lr=1e-2)
    host = _opt_params(rng)
    rp = {k: v for k, v in jax.tree.map(jnp.asarray, host).items()}
    pp = params_from_numpy(host, "cpu")
    for path in BF16_LEAVES:
        keys = path.split("/")
        r, p = rp, pp
        for k in keys[:-1]:
            r, p = r[k], p[k]
        r[keys[-1]] = r[keys[-1]].astype(jnp.bfloat16)
        p[keys[-1]] = p[keys[-1]].to(torch.bfloat16)
    ropt, popt = ref_opt.opt_init(rp, cfg_r), optimizer.opt_init(pp, cfg_p)
    assert jax.tree.structure(jax.tree.map(np.asarray, ropt)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), popt))
    for step in range(3):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape)
                         .astype(np.float32), host)
        rp, ropt = ref_opt.opt_update(jax.tree.map(jnp.asarray, g), ropt, rp,
                                      jnp.asarray(step, jnp.int32), cfg_r)
        pp, popt = optimizer.opt_update(params_from_numpy(g, "cpu"), popt, pp,
                                        torch.tensor(step, dtype=torch.int32),
                                        cfg_p)
        want, got = leaves_by_path(ropt), leaves_by_path(popt)
        assert sorted(want) == sorted(got)
        for path in want:
            np.testing.assert_allclose(f32(got[path]), f32(want[path]),
                                       rtol=1e-6, atol=0,
                                       err_msg=f"{name} step {step} {path}")
        want, got = leaves_by_path(rp), leaves_by_path(pp)
        n_diff = n_all = 0
        for path in want:
            a, b = f32(want[path]), f32(got[path])
            assert got[path].dtype == (torch.bfloat16 if path in BF16_LEAVES
                                       else torch.float32), path
            assert (np.abs(a - b) <= bf16_ulp(np.maximum(np.abs(a),
                                                         np.abs(b)))).all()
            n_diff += int((a != b).sum())
            n_all += a.size
        assert n_diff <= n_all // 1000, f"{name} step {step}: {n_diff} differ"


def test_is_frozen_matches_the_reference():
    frozen = ("layers/0", "embed")
    for path in (("embed",), ("layers", "0", "attn", "wq"), ("layers", "1"),
                 ("layers", "01"), ("embedding",), ("final_norm", "scale")):
        assert optimizer.is_frozen(path, frozen) == \
            ref_opt.is_frozen(path, frozen)


@pytest.mark.parametrize("norm", [0.1, 1.0, 9.48, 9.5, 37.0, 100.0])
def test_clip_by_global_norm_matches_the_reference(norm):
    rng = np.random.default_rng(2)
    g = {"b": rng.standard_normal((7, 5)).astype(np.float32) * 2,
         "a": np.full((10,), 3.0, np.float32)}
    rc, rn = ref_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), norm)
    pc, pn = optimizer.clip_by_global_norm(params_from_numpy(g, "cpu"), norm)
    np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(f32(pc[k]), f32(rc[k]), rtol=1e-6,
                                   atol=1e-7)
    got = float(torch.linalg.vector_norm(torch.cat(
        [pc[k].reshape(-1) for k in g])))
    assert got <= norm * 1.001 + 1e-6


@pytest.mark.parametrize("n", [256, 1000, 3 * 256 + 1])
def test_quantize_is_bit_equal_to_the_reference(n):
    """q, scale, g_hat and the error feedback: bit-equal (IEEE float32
    division, round-half-even and clamping in both)."""
    rng = np.random.default_rng(n)
    g = (rng.standard_normal(n) * 3).astype(np.float32)
    g[::7] = 0.0
    ef = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    ef16 = jnp.asarray(ef, jnp.bfloat16)
    rq, rs, rn = ref_gc.quantize(jnp.asarray(g))
    pq, ps, pn = grad_compress.quantize(torch.from_numpy(g))
    assert rn == pn == n and pq.dtype == torch.int8
    assert np.array_equal(np.asarray(rq), pq.numpy())
    assert np.array_equal(bits(np.asarray(rs)), bits(ps))
    for ef_r, ef_p in ((None, None),
                       (ef16, params_from_numpy(np.asarray(ef16), "cpu"))):
        rg, ref_ef = ref_gc.quantize_dequantize(jnp.asarray(g), ef_r)
        pg, port_ef = grad_compress.quantize_dequantize(torch.from_numpy(g),
                                                        ef_p)
        assert np.array_equal(bits(np.asarray(rg)), bits(pg))
        assert port_ef.dtype == torch.bfloat16
        assert np.array_equal(bits(np.asarray(ref_ef)), bits(port_ef))


# ---------------------------------------------------------------------------
# model pieces the step needs
# ---------------------------------------------------------------------------

def test_round_to_equals_torch_rounding():
    from repro_torch.configs import ARCHS
    import math
    for dt in (torch.bfloat16, torch.float16, torch.float32, torch.float64):
        for d in sorted({c.d_model for c in ARCHS.values()}
                        | {c.reduced().d_model for c in ARCHS.values()}):
            v = math.sqrt(d)
            assert round_to(v, dt) == float(torch.tensor(v, dtype=dt)), (dt, d)
        v = math.sqrt(2 / math.pi)
        assert round_to(v, dt) == float(torch.tensor(v, dtype=dt)), dt


def test_cross_entropy_matches_the_reference():
    from repro.models import transformer as ref_transformer
    from repro_torch.models import transformer
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((2, 5, 33)) * 4).astype(np.float32)
    labels = rng.integers(0, 33, size=(2, 5)).astype(np.int32)
    want = ref_transformer.sharded_cross_entropy(
        jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels))
    got = transformer.sharded_cross_entropy(
        torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

def _step_pair(arch, B=2, **kw):
    """(reference new state, metrics) of its step run op by op, and the
    port's, from the same parameters and a batch of B sequences."""
    cfg = get_config(arch).reduced()
    ref_cfg = ref_get_config(arch).reduced()
    host = ref_state_np(ref_cfg, ref_opt.OptConfig(lr=LR),
                        grad_compress=kw.get("grad_compress", False))
    batch = batch_np(cfg, B=B)
    ref_step = ref_ts.make_train_step(ref_cfg, ref_opt.OptConfig(lr=LR),
                                      remat=False, **kw)
    rnew, rmet = ref_step(jax.tree.map(jnp.asarray, host), as_jax(batch))
    port_step = train_step.make_train_step(cfg, optimizer.OptConfig(lr=LR),
                                           remat=False, **kw)
    pnew, pmet = port_step(train_state_from_numpy(host, "cpu"),
                           as_torch(batch))
    return (rnew, rmet), (pnew, pmet)


def _assert_step_close(ref, port, what):
    (rnew, rmet), (pnew, pmet) = ref, port
    for k in ("nll", "grad_norm"):
        np.testing.assert_allclose(float(pmet[k]), float(rmet[k]),
                                   rtol=RTOL_LOSS, err_msg=f"{what} {k}")
    assert int(pnew["step"]) == int(rnew["step"]) == 1
    assert pnew["step"].dtype == torch.int32
    assert_params_within(pnew["params"], rnew["params"], what=what)
    want, got = leaves_by_path(rnew["opt"]), leaves_by_path(pnew["opt"])
    assert sorted(want) == sorted(got)
    # AdamW's first moment after one step is (1 - b1) * g in float32: the
    # gradient's direction, which the update's sign hides, leaf by leaf
    mus = [p for p in want if p.startswith("mu/")]
    assert len(mus) == len(leaves_by_path(rnew["params"]))
    for path in mus:
        w, g = f32(want[path]), f32(got[path])
        assert got[path].dtype == torch.float32, path
        assert np.linalg.norm(g - w) <= RTOL_LOSS * np.linalg.norm(w) \
            + 1e-12, f"{what} opt/{path}"


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_train_step_matches_the_reference(arch):
    ref, port = _step_pair(arch)
    _assert_step_close(ref, port, arch)
    (_, rmet), (_, pmet) = ref, port
    assert sorted(pmet) == sorted(rmet)
    if "expert_counts" in rmet:            # the MoE touch report, exact
        assert pmet["expert_counts"].dtype == torch.float32
        assert np.array_equal(pmet["expert_counts"].numpy(),
                              np.asarray(rmet["expert_counts"]))
        np.testing.assert_allclose(float(pmet["moe_aux"]),
                                   float(rmet["moe_aux"]), rtol=1e-5)


def test_grad_compress_step_matches_the_reference():
    """The step with int8 compression, against the reference's step, with
    the tolerances above.  Its error feedback is a residual of under half
    a quantization step, so a gradient that differs in a last bf16 bit
    moves it by up to a whole step: it is held as a chain instead.  The
    step's ``ef`` is exactly `tree_quantize_dequantize` of the port's own
    gradients; that transform is bit-equal to the reference's on the same
    input (here the reference's gradients); and the port's gradients are
    within 2e-2 relative (by norm, per leaf) of the reference's."""
    from repro.models.model import api as ref_api
    from repro_torch.models.model import api
    ref, port = _step_pair("qwen1.5-0.5b", grad_compress=True)
    _assert_step_close(ref, port, "grad_compress")
    cfg = get_config("qwen1.5-0.5b").reduced()
    ref_cfg = ref_get_config("qwen1.5-0.5b").reduced()
    host = ref_state_np(ref_cfg, ref_opt.OptConfig(lr=LR))
    batch = batch_np(cfg)
    _, rg = jax.value_and_grad(
        lambda p, b: ref_api(ref_cfg).loss_fn(p, b, ref_cfg, remat=False),
        has_aux=True)(jax.tree.map(jnp.asarray, host["params"]),
                      as_jax(batch))
    _, pg = train_step.value_and_grad(
        lambda p, b: api(cfg).loss_fn(p, b, cfg, remat=False))(
        params_from_numpy(host["params"], "cpu"), as_torch(batch))
    _, step_ef = grad_compress.tree_quantize_dequantize(pg, None)
    assert_trees_bit_equal(port[0]["ef"], step_ef)
    rg_np = jax.tree.map(np.asarray, rg)
    want = ref_gc.tree_quantize_dequantize(jax.tree.map(jnp.asarray, rg_np),
                                           None)
    got = grad_compress.tree_quantize_dequantize(
        params_from_numpy(rg_np, "cpu"), None)
    for w, g in zip(want, got):
        assert_trees_bit_equal(g, jax.tree.map(np.asarray, w))
    for path, w in leaves_by_path(rg_np).items():
        g = f32(leaves_by_path(pg)[path])
        w = f32(w)
        assert np.linalg.norm(g - w) <= RTOL_LOSS * np.linalg.norm(w) \
            + 1e-12, path


@pytest.mark.parametrize("scan", [False, True])
def test_microbatch_step_matches_the_reference(scan):
    """Two microbatches against the reference's step run op by op,
    unrolled or under its `lax.scan` (the port runs one loop for both)."""
    ref, port = _step_pair("qwen1.5-0.5b", B=4, microbatches=2,
                           microbatch_scan=scan)
    _assert_step_close(ref, port, f"microbatches=2, scan={scan}")


def _port_step_inputs(arch="qwen1.5-0.5b", B=4):
    cfg = get_config(arch).reduced()
    host = ref_state_np(ref_get_config(arch).reduced(),
                        ref_opt.OptConfig(lr=LR))
    return cfg, host, batch_np(cfg, B=B)


def test_microbatch_loop_and_scan_agree():
    cfg, host, batch = _port_step_inputs()
    outs = []
    for scan in (False, True):
        step = train_step.make_train_step(cfg, optimizer.OptConfig(lr=LR),
                                          microbatches=2,
                                          microbatch_scan=scan, remat=False)
        outs.append(step(train_state_from_numpy(host, "cpu"),
                         as_torch(batch)))
    assert_trees_bit_equal(outs[0][0], outs[1][0])
    assert float(outs[0][1]["nll"]) == float(outs[1][1]["nll"])
    # two microbatches of 2 average to the loss of one batch of 4
    one = train_step.make_train_step(cfg, optimizer.OptConfig(lr=LR),
                                     remat=False)
    _, met = one(train_state_from_numpy(host, "cpu"), as_torch(batch))
    np.testing.assert_allclose(float(outs[0][1]["nll"]), float(met["nll"]),
                               rtol=1e-5)


def test_remat_is_bit_equal_to_no_remat():
    cfg, host, batch = _port_step_inputs("starcoder2-3b", B=2)
    outs = []
    for remat in (False, True):
        step = train_step.make_train_step(cfg, optimizer.OptConfig(lr=LR),
                                          remat=remat)
        outs.append(step(train_state_from_numpy(host, "cpu"),
                         as_torch(batch)))
    assert_trees_bit_equal(outs[0][0], outs[1][0])
    assert float(outs[0][1]["grad_norm"]) == float(outs[1][1]["grad_norm"])


def test_frozen_leaves_are_returned_as_the_same_objects():
    cfg, host, batch = _port_step_inputs()
    state = train_state_from_numpy(host, "cpu")
    step = train_step.make_train_step(
        cfg, optimizer.OptConfig(lr=LR),
        frozen=("params/layers/0", "embed"), remat=False)
    new, _ = step(state, as_torch(batch))
    old_p, new_p = leaves_by_path(state["params"]), \
        leaves_by_path(new["params"])
    for path, t in old_p.items():
        frozen = path == "embed" or path.startswith("layers/0/")
        assert (new_p[path] is t) == frozen, path
    # their optimizer state is recomputed (from zeroed grads), as in the
    # reference: only the parameters pass through
    assert new["opt"]["mu"]["embed"] is not state["opt"]["mu"]["embed"]


# ---------------------------------------------------------------------------
# touch report, straggler monitor
# ---------------------------------------------------------------------------

def test_touched_prefixes_match_the_reference():
    """The touch report of the port's own MoE step: its `expert_counts`
    (from `loss_fn` on a batch), and the same with one layer's experts
    all idle, give the reference's prefixes."""
    from repro_torch.models.model import api
    arch = "granite-moe-3b-a800m"
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    n_moe = sum(1 for _, f in cfg.layer_plan() if f == "moe")
    assert n_moe >= 2
    host = ref_state_np(ref_cfg, ref_opt.OptConfig(lr=LR))
    _, met = api(cfg).loss_fn(params_from_numpy(host["params"], "cpu"),
                              as_torch(batch_np(cfg)), cfg, remat=False)
    counts = met["expert_counts"]
    assert counts.shape == (n_moe, cfg.moe.n_experts)
    assert float(counts.sum()) == n_moe * 2 * 16 * cfg.moe.top_k
    idle = counts.clone()
    idle[1] = 0
    for c in (counts, idle):
        for frozen in ((), ("params/layers/0",)):
            want = ref_ts.touched_prefixes_from_metrics(
                ref_cfg, {"expert_counts": jnp.asarray(c.numpy())}, frozen)
            for got in (c, c.numpy()):
                assert train_step.touched_prefixes_from_metrics(
                    cfg, {"expert_counts": got}, frozen) == want
    assert ("params/layers/1/ffn" in train_step.touched_prefixes_from_metrics(
        cfg, {"expert_counts": counts})) != ("params/layers/1/ffn" in
        train_step.touched_prefixes_from_metrics(cfg, {"expert_counts": idle}))
    dense = get_config("qwen1.5-0.5b").reduced()
    assert train_step.touched_prefixes_from_metrics(
        dense, {"nll": torch.zeros(())}) is None
    assert train_step.touched_prefixes_from_metrics(
        dense, {"expert_counts": counts}) is None


def test_straggler_monitor_matches_the_reference():
    reports = []
    for cls in (RefMonitor, StragglerMonitor):
        mon = cls(window=8, threshold=1.5, min_samples=4)
        rng = np.random.default_rng(0)
        for _ in range(10):
            for host in range(8):
                base = 1.0 + 0.05 * rng.standard_normal()
                if host == 3:
                    base *= 2.5  # slow host
                mon.record(host, base)
        rep = mon.report()
        reports.append((rep.stragglers, rep.medians, rep.global_median,
                        mon.healthy_hosts(range(8))))
    assert reports[0] == reports[1]
    assert reports[1][0] == [3]


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------

def test_supervisor_absorbs_a_failed_save_like_the_reference(tmp_path):
    """The port's counterpart of `test_faults.py`'s supervisor test, on
    CPU tensors: the second save's manifest write fails through all its
    retries, a step fails at 11, the restart absorbs the failed save,
    runs fsck and resumes from the step-5 commit."""
    out = {}
    for name in ("ref", "port"):
        root = tmp_path / name
        if name == "ref":
            fs = RefFaultyStore(RefFileStore(str(root)))
            ck = RefChipmink(store=fs, use_kernel=False, async_mode=True,
                             fsck_on_open=False,
                             retry_policy=RefRetryPolicy(backoff_s=0.001))
            sup = RefSupervisor(ck, save_every=5, max_restarts=4)
            w0, one = np.zeros(16, np.float32), np.float32(1)
        else:
            fs = FaultyStore(FileStore(str(root)))
            ck = Chipmink(store=fs, async_mode=True, fsck_on_open=False,
                          retry_policy=RetryPolicy(backoff_s=0.001),
                          device="cpu")
            sup = TrainingSupervisor(ck, save_every=5, max_restarts=4)
            w0, one = torch.zeros(16), 1.0

        def step(state, i, one=one):
            state = dict(state)
            state["w"] = state["w"] + one
            state["step"] = np.int64(i + 1)
            return state

        def snap(state):
            return {"w": state["w"], "step": np.int64(state["step"])}

        fs.transient("put_manifest", times=4, skip=1)
        final, stats = sup.run({"w": w0, "step": np.int64(0)}, 20, step,
                               make_snapshot=snap, restore=lambda d: dict(d),
                               fail_at={11})
        out[name] = (stats, ck.saver.n_failed, int(final["step"]),
                     f32(final["w"]))
        ck.close()
    (rs, rf, rstep, rw), (ps, pf, pstep, pw) = out["ref"], out["port"]
    assert ps == rs == {"failures": 1, "resumed_from": [5], "save_errors": 1}
    assert pf == rf == 1 and pstep == rstep == 20
    assert np.array_equal(pw, rw) and float(pw[0]) == 20.0


def test_supervisor_restarts_a_reduced_trainer_exactly():
    """Failures at steps 7 and 13 with a save every 5: the run resumes
    from the step-5 and step-10 commits (the data cursor rides along),
    and its final state is bit-equal to an uninterrupted run's."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    opt_cfg = optimizer.OptConfig(lr=1e-3)
    host = ref_state_np(ref_get_config("qwen1.5-0.5b").reduced(),
                        ref_opt.OptConfig(lr=1e-3))
    step_fn = train_step.make_train_step(cfg, opt_cfg, remat=False)

    def run(fail_at):
        pipe = data.TokenPipeline(cfg.vocab, 4, 32)

        def do_step(st, i):
            new, _ = step_fn(st, port_train.batch_on(pipe.next_batch(),
                                                     "cpu"))
            return new

        def restore(loaded):
            pipe.restore(loaded["data"])
            return train_state_from_numpy(loaded, "cpu")

        ck = Chipmink(MemoryStore(), LGA(), chunk_bytes=1 << 16, device="cpu")
        sup = TrainingSupervisor(ck, save_every=5)
        final, stats = sup.run(
            train_state_from_numpy(host, "cpu"), 20, do_step,
            make_snapshot=lambda st: port_train.snapshot_of(st, pipe),
            restore=restore, fail_at=fail_at)
        return final, stats

    final, stats = run({7, 13})
    assert stats["failures"] == 2 and stats["resumed_from"] == [5, 10]
    assert int(final["step"]) == 20
    plain, stats = run(None)
    assert stats["failures"] == 0
    assert_trees_bit_equal(final, plain)


# ---------------------------------------------------------------------------
# the slice whole: train()
# ---------------------------------------------------------------------------

TRAIN_KW = dict(reduced=True, steps=4, save_every=2, global_batch=2,
                seq_len=16, async_save=False, log=False)


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """The reference's `train` and the port's (its init patched to the
    reference's parameters), each into a FileStore."""
    root = tmp_path_factory.mktemp("train")
    ref_params = jax.tree.map(np.asarray, ref_init_params(
        ref_get_config("qwen1.5-0.5b").reduced(), jax.random.key(0)))
    with pytest.MonkeyPatch.context() as mp:
        ref_ro = capture_readonly(mp, ref_train)
        port_ro = capture_readonly(mp, port_train)
        ref = ref_train.train("qwen1.5-0.5b", store_dir=str(root / "ref"),
                              **TRAIN_KW)
        mp.setattr(port_train, "init_model_params",
                   lambda cfg, gen, device: params_from_numpy(ref_params,
                                                              device))
        port = port_train.train("qwen1.5-0.5b", store_dir=str(root / "port"),
                                device="cpu", **TRAIN_KW)
    ref["readonly"], port["raw_readonly"] = ref_ro[0], port_ro[0]
    yield ref, port, root
    port["chipmink"].close()
    ref["chipmink"].close()


def test_train_matches_the_reference(both_runs):
    ref, port, _ = both_runs
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=RTOL_LOSS)
    rs, ps = ref["chipmink"].save_stats, port["chipmink"].save_stats
    assert len(ps) == len(rs) == 2
    for r, p in zip(rs, ps):
        for k in ("n_leaves", "n_active_leaves"):
            assert p[k] == r[k], k
    assert ps[0]["bytes_written"] == rs[0]["bytes_written"]
    assert port["raw_readonly"] == ref["readonly"] == set()
    assert port["pipeline"].cursor() == ref["pipeline"].cursor()
    rl, pl = ref["chipmink"].load(), port["chipmink"].load()
    assert sorted(leaves_by_path(pl)) == sorted(leaves_by_path(rl))
    assert pl["data"] == rl["data"] and pl["step"] == rl["step"] == 4


def test_frozen_train_matches_the_reference():
    kw = dict(TRAIN_KW, steps=2, save_every=1,
              frozen=("params/layers/0", "params/embed"))
    with pytest.MonkeyPatch.context() as mp:
        ref_ro = capture_readonly(mp, ref_train)
        port_ro = capture_readonly(mp, port_train)
        ref = ref_train.train("qwen1.5-0.5b", **kw)
        port = port_train.train("qwen1.5-0.5b", device="cpu", **kw)
    assert port_ro == ref_ro
    rs, ps = ref["chipmink"].save_stats, port["chipmink"].save_stats
    for r, p in zip(rs, ps):
        for k in ("n_leaves", "n_active_leaves", "bytes_written"):
            assert p[k] == r[k], k
    assert ps[1]["n_active_leaves"] == ps[1]["n_leaves"] - len(
        port["readonly"])
    assert port["readonly"] == {
        p for p in leaves_by_path(port["state"])
        if p == "params/embed" or p.startswith("params/layers/0/")}


def test_stores_load_bit_exact_across_packages(both_runs):
    ref, port, root = both_runs
    got = Chipmink(FileStore(str(root / "ref")), device="cpu").load()
    assert_trees_bit_equal(
        {k: got[k] for k in ("params", "opt", "step")},
        jax.tree.map(np.asarray, {k: ref["state"][k]
                                  for k in ("params", "opt", "step")}))
    assert got["data"] == ref["pipeline"].cursor()
    want = RefChipmink(RefFileStore(str(root / "port"))).load()
    assert_trees_bit_equal(
        {k: port["state"][k] for k in ("params", "opt", "step")},
        {k: want[k] for k in ("params", "opt", "step")})


def test_port_resumes_training_from_a_reference_store(both_runs):
    """Load the reference's last commit (step 4) into the port and run 2
    more steps; the reference resumes from the same commit with its own
    step: losses within 2e-2."""
    ref, _, root = both_runs
    cfg = get_config("qwen1.5-0.5b").reduced()
    loaded = Chipmink(FileStore(str(root / "ref")), device="cpu").load()
    state = train_state_from_numpy(loaded, "cpu")
    assert int(state["step"]) == 4 and state["step"].dtype == torch.int32
    pipe = data.TokenPipeline(cfg.vocab, 2, 16)
    pipe.restore(loaded["data"])
    step = train_step.make_train_step(cfg, optimizer.OptConfig(lr=1e-3),
                                      remat=False)
    ref_loaded = RefChipmink(RefFileStore(str(root / "ref"))).load()
    rstate = {"params": jax.tree.map(jnp.asarray, ref_loaded["params"]),
              "opt": jax.tree.map(jnp.asarray, ref_loaded["opt"]),
              "step": jnp.asarray(ref_loaded["step"], jnp.int32)}
    rpipe = ref_data.TokenPipeline(cfg.vocab, 2, 16)
    rpipe.restore(ref_loaded["data"])
    rstep = jax.jit(ref_ts.make_train_step(
        ref_get_config("qwen1.5-0.5b").reduced(),
        ref_opt.OptConfig(lr=1e-3), remat=False))
    for _ in range(2):
        b = pipe.next_batch()
        rb = rpipe.next_batch()
        assert np.array_equal(b["tokens"], rb["tokens"])
        state, met = step(state, as_torch(b))
        rstate, rmet = rstep(rstate, as_jax(rb))
        np.testing.assert_allclose(float(met["nll"]), float(rmet["nll"]),
                                   rtol=RTOL_LOSS)
    assert int(state["step"]) == 6


def test_train_cli_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["train", "--steps", "2", "--save-every",
                                     "2", "--batch", "2", "--seq", "16",
                                     "--sync-save", "--device", "cpu"])
    port_train.main()
    out = capsys.readouterr().out
    assert "saved TimeID=1" in out and "done: 2 steps" in out
