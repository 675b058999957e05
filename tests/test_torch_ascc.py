"""The port's static checker (`repro_torch.core.ascc`, on traced torch
graphs) vs the reference's (`repro.core.ascc`, on jaxprs), on the CPU.

Sets of read-only paths must be equal where both packages can express
the step.  The torch-only cases are a step that changes a leaf in place
(directly or through a view) and returns the same object, which must
never be called read-only, and the value-preserving ops a torch step may
return a leaf through.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import ascc as ref_ascc
from repro.models.model import init_model_params as ref_init_params
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch.configs import get_config
from repro_torch.core import ascc
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.train import optimizer, train_step

PKGS = {"ref": (ref_ascc, jnp.asarray), "port": (ascc, torch.as_tensor)}


def both(step_ref, step_port, state, *rest):
    """readonly_state_leaves in both packages, from the same numpy
    arguments."""
    conv = lambda t, f: {k: conv(v, f) for k, v in t.items()} \
        if isinstance(t, dict) else (f(t) if isinstance(t, np.ndarray)
                                     else t)
    out = []
    for name, step in (("ref", step_ref), ("port", step_port)):
        mod, f = PKGS[name]
        out.append(mod.readonly_state_leaves(
            step, conv(state, f), *(conv(r, f) for r in rest)))
    return out


def ones(n):
    return np.ones((n,), np.float32)


# -- the reference's four cases (tests/test_ascc_avf.py) ---------------------

def test_identity_passthrough_matches_the_reference():
    def step(state, x):
        return {"a": state["a"], "b": state["b"] + x}, state["a"].sum()

    ref, port = both(step, step, {"a": ones(4), "b": np.zeros(4, np.float32)},
                     ones(4))
    assert port == ref == {"a"}


def test_full_readonly_is_static_in_both():
    def eval_step(state, x):
        return state, (state["w"] * x).sum()

    assert ref_ascc.is_static_execution(eval_step, {"w": jnp.ones((8,))},
                                        jnp.ones((8,)))
    assert ascc.is_static_execution(eval_step, {"w": torch.ones(8)},
                                    torch.ones(8))


def test_mutation_not_static_in_both():
    def step(state, x):
        return {"w": state["w"] + x}, None

    ref, port = both(step, step, {"w": ones(8)}, ones(8))
    assert port == ref == set()
    assert not ascc.is_static_execution(step, {"w": torch.ones(8)},
                                        torch.ones(8))


def test_value_identical_rewrite_is_not_readonly_in_both():
    def sneaky(state, x):
        return {"w": state["w"] * 1.0}, None  # value-identical rewrite

    ref, port = both(sneaky, sneaky, {"w": ones(8)}, ones(8))
    assert port == ref == set()


# -- torch-only hazards and pass-throughs ------------------------------------

def _inplace_add(state, x):
    state["w"].add_(x)
    return state, None


def _inplace_slice(state, x):
    state["w"][2:].mul_(2.0)
    return state, None


def _inplace_reshaped_view(state, x):
    state["w"].view(2, 4)[1].zero_()
    return state, None


def _inplace_index_put(state, x):
    state["w"][torch.tensor([0, 3])] = 5.0
    return state, None


def _inplace_through_alias_leaf(state, x):
    state["v"].copy_(x)            # "v" is a view of "w"
    return state, None


@pytest.mark.parametrize("step", [_inplace_add, _inplace_slice,
                                  _inplace_reshaped_view, _inplace_index_put])
def test_a_leaf_changed_in_place_is_never_readonly(step):
    state = {"w": torch.ones(8), "u": torch.ones(8)}
    ro = ascc.readonly_state_leaves(step, state, torch.ones(8))
    assert ro == {"u"}
    assert not ascc.is_static_execution(step, state, torch.ones(8))
    assert torch.equal(state["w"], torch.ones(8))   # fake tracing wrote nothing


def test_a_write_through_another_leafs_view_is_seen():
    w = torch.ones(8)
    state = {"w": w, "v": w[4:], "u": torch.ones(4)}
    ro = ascc.readonly_state_leaves(_inplace_through_alias_leaf, state,
                                    torch.zeros(4))
    assert ro == {"u"}          # "w" changed too: it shares the storage


@pytest.mark.parametrize("op,readonly", [
    (lambda t: t.detach(), True),
    (lambda t: t.clone(), True),
    (lambda t: t.to(torch.float32), True),
    (lambda t: t.to(torch.float32, copy=True), True),
    (lambda t: t.reshape(8), True),
    (lambda t: t.view(8), True),
    (lambda t: t.detach().clone().reshape(8), True),
    (lambda t: t.to(torch.bfloat16), False),
    (lambda t: t.to(torch.float64).to(torch.float32), False),
    (lambda t: t.view(2, 4), False),
    (lambda t: t + 0, False),
    (lambda t: torch.ones_like(t), False),
    (lambda t: t.clone().add_(1), False),
    (lambda t: t.clone().copy_(torch.zeros(8)), False),
    (lambda t: torch.add(t, 1, out=t.clone()), False),
    (lambda t: t.detach().view(2, 4).mul_(2).view(8), False),
])
def test_value_preserving_ops(op, readonly):
    def step(state, x):
        return {"w": op(state["w"]), "u": state["u"] * x}, None

    ro = ascc.readonly_state_leaves(step, {"w": torch.ones(8),
                                           "u": torch.ones(8)}, torch.ones(8))
    assert ro == ({"w"} if readonly else set())


def test_scalars_trace_like_the_reference():
    """Python scalars and numpy arrays are traced as arrays (as jax
    does): passed through -> read-only, computed on -> not."""
    def step(state, x):
        return {"n": state["n"], "m": state["m"] + 1, "a": state["a"],
                "w": state["w"] * x}, None

    state = {"n": 3, "m": 4, "a": np.arange(3), "w": ones(2)}
    ref, port = both(step, step, state, ones(2))
    assert port == ref == {"a", "n"}


def test_state_argnum_and_paths_of_nested_lists():
    def step(x, state):
        return {"p": [state["p"][0], state["p"][1] * x]}, None

    state = {"p": [torch.ones(2), torch.ones(2)]}
    ro = ascc.readonly_state_leaves(step, torch.ones(2), state,
                                    state_argnum=1)
    assert ro == {"p/0"}
    assert ascc._flatten_paths({"b": [1, {"c": 2}], "a": 0}) == \
        ref_ascc._flatten_paths({"b": [1, {"c": 2}], "a": 0})


def test_host_allowlist_matches_the_reference():
    assert ascc.STATIC_HOST_ALLOWLIST == ref_ascc.STATIC_HOST_ALLOWLIST
    for op in ("len", "print", "peek", "append", "save", ""):
        assert ascc.host_call_is_static(op) == ref_ascc.host_call_is_static(op)
        assert ascc.host_call_is_static(op, {"save"}) == \
            ref_ascc.host_call_is_static(op, {"save"})


# -- the reduced train step ---------------------------------------------------

@pytest.mark.parametrize("frozen", [(), ("params/layers/0", "params/embed")])
def test_train_step_readonly_set_matches_the_reference(frozen):
    arch = "qwen1.5-0.5b"
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    params = ref_init_params(ref_cfg, jax.random.key(0))
    rstate = ref_ts.init_train_state(ref_cfg, params,
                                     ref_opt.OptConfig(lr=1e-3))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, size=(2, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    ref_step = jax.jit(ref_ts.make_train_step(
        ref_cfg, ref_opt.OptConfig(lr=1e-3), frozen=frozen, remat=False))
    want = ref_ascc.readonly_state_leaves(
        ref_step, rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    port_step = train_step.make_train_step(
        cfg, optimizer.OptConfig(lr=1e-3), frozen=frozen, remat=False)
    state = train_state_from_numpy(jax.tree.map(np.asarray, rstate), "cpu")
    got = ascc.readonly_state_leaves(
        port_step, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got == want
    if frozen:
        assert "params/embed" in got and "opt/mu/embed" not in got
        assert all(p.startswith(("params/embed", "params/layers/0/"))
                   for p in got)


def test_remat_step_traces_and_frozen_set_holds():
    """Remat's recomputation (non-reentrant checkpoint) traces too."""
    cfg = get_config("starcoder2-3b").reduced()
    ref_cfg = ref_get_config("starcoder2-3b").reduced()
    host = jax.tree.map(np.asarray, ref_ts.init_train_state(
        ref_cfg, ref_init_params(ref_cfg, jax.random.key(1)),
        ref_opt.OptConfig()))
    step = train_step.make_train_step(cfg, optimizer.OptConfig(),
                                      frozen=("params/final_norm",),
                                      remat=True)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    ro = ascc.readonly_state_leaves(step, train_state_from_numpy(host, "cpu"),
                                    {"tokens": toks, "labels": toks})
    assert ro == {"params/final_norm/bias", "params/final_norm/scale"}


# -- the write check against an eager run -----------------------------------

def _clone_add(state, x):
    return {"w": state["w"].clone().add_(1), "u": state["u"]}, None


def _clone_copy(state, x):
    return {"w": state["w"].clone().copy_(x), "u": state["u"]}, None


def _out_into_clone(state, x):
    return {"w": torch.add(state["w"], x, out=state["w"].clone()),
            "u": state["u"]}, None


@pytest.mark.parametrize("step", [_inplace_add, _inplace_slice,
                                  _inplace_reshaped_view, _inplace_index_put,
                                  lambda s, x: ({"w": s["w"] * x,
                                                 "u": s["u"]}, None),
                                  _clone_add, _clone_copy, _out_into_clone])
def test_written_inputs_equal_functionalizations_copy_backs(step):
    """The inputs the functionalized graph writes back into are exactly
    those the step changes when it runs eagerly, and only the leaf
    passed through untouched is read-only (a clone written in place is
    no pass-through)."""
    args = ({"w": torch.ones(8), "u": torch.ones(8)}, torch.full((8,), 3.0))
    tr = ascc._Trace(step, args)
    before = [t.clone() for t in tr.flat]
    step(*tr.traced)
    changed = {i for i, t in enumerate(tr.flat)
               if not torch.equal(t, before[i])}
    assert tr.written() == changed
    assert ascc.readonly_state_leaves(
        step, {"w": torch.ones(8), "u": torch.ones(8)},
        torch.full((8,), 3.0)) == {"u"}


def test_storage_swaps_and_foreign_devices():
    """``.data`` swaps a leaf's storage without an aten op: written.  A
    factory op with ``device=`` and a same-device ``.to(device)`` trace
    on meta tensors."""
    def swap(state, x):
        state["w"].data = x
        return state, None

    assert ascc.readonly_state_leaves(
        swap, {"w": torch.ones(8), "u": torch.ones(8)}, torch.zeros(8)) \
        == {"u"}

    def devices(state, x):
        return {"w": state["w"].to("cpu"),
                "u": state["u"] + torch.zeros(8, device="cpu")}, None

    assert ascc.readonly_state_leaves(
        devices, {"w": torch.ones(8), "u": torch.ones(8)},
        torch.zeros(8)) == {"w"}
