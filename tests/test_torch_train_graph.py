"""The port's compiled train step (`repro_torch.train.train_step.
compile_train_step`, a `TrainGraph` per TrainState) against the
reference's jitted step and the port's eager step, on the CPU, at the
reduced configs of every arch `test_torch_train.py` trains.

On the CPU a `TrainGraph` runs the body a card replays, eagerly, through
the same static buffers (batch buffers, the state's own tensors, metric
buffers), so these tests cover the plumbing of the graph: the state comes
back as the same dict of the same tensors, written in place; frozen
leaves are never written; the step counter advances on the device; a
state, batch or device other than the bound one raises; `train` steps
through it; and an async save taken before a step still commits the state
as it was at `save()`.

Numerics: the reference runs as `repro.launch.train` runs it,
`jax.jit(make_train_step(...))`, so it needs a tolerance: under `jax.jit`
XLA fuses bf16 elementwise chains and skips the roundings the port
reproduces op by op (`test_torch_models.py`).  The step is held to
`test_torch_train.py`'s tolerances (`_assert_step_close`, there against
the reference run op by op): loss and grad norm within ``RTOL_LOSS``
(2e-2) relative, params within 2 * lr + 1 bf16 ulp elementwise, and
AdamW's ``mu`` (after one step the gradient's direction) within 2e-2 by
norm, here over the whole tree.  Leaf by leaf ``mu`` is held within
``JIT_MU_LEAF`` (1e-1) by norm: a leaf whose gradient is mostly rounding
(a key bias, whose exact gradient is 0 since a softmax ignores a shift
common to its scores; an RG-LRU gate) moves with the skipped roundings.
Over the ten reduced configs the whole-tree error is 0.9-1.4% and the
worst leaf 4.7% (recurrentgemma-9b's ``gate_a``; key and query biases
1.4-2.5%); loss and grad norm agree within 6e-4.  Where the fused
roundings flip an MoE expert choice, the router's gradient moves by tens
of percent in the reference's own jitted step against its step run op by
op; the port's choices are the op-by-op reference's, so there the step is
held against that, with the same tolerances.  The graph's body
against the eager step is bit for bit.  The tests that need a card
(capture leaves the state untouched; the replay against the eager step)
are in `test_torch_train_graph_card.py`, which imports no JAX.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch.configs import get_config
from repro_torch.core import Chipmink, LGA, MemoryStore
from repro_torch.launch import train as port_train
from repro_torch.models.model import init_model_params
from repro_torch.train import optimizer, train_step
from repro_torch.train.tree import tree_leaves_with_paths, tree_map

from test_torch_checkpoint import to_jax
from test_torch_train import (DENSE, FAMILIES, LR, RTOL_LOSS,
                              _assert_step_close, as_jax, as_torch,
                              assert_params_within,
                              assert_trees_bit_equal, batch_np, f32,
                              leaves_by_path)
from test_torch_version import from_torch

SRC = Path(__file__).resolve().parents[1] / "src"
#: ``mu`` against the jitted reference, leaf by leaf, by norm (see the
#: module docstring)
JIT_MU_LEAF = 1e-1
#: make_train_step options the eager step is held against, bit for bit
OPTIONS = {
    "plain": {},
    "remat": dict(remat=True),
    "microbatches": dict(microbatches=2),
    "grad_compress": dict(grad_compress=True),
    "frozen": dict(frozen=("params/layers/0", "embed")),
}
STEPS = 4


def fresh(cfg, grad_compress=False):
    params = init_model_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    return train_step.init_train_state(cfg, params,
                                       optimizer.OptConfig(lr=LR),
                                       grad_compress=grad_compress)


def compiled(arch="qwen1.5-0.5b", B=2, **kw):
    """(cfg, eager step, a fresh state, batches of B sequences, one per
    step, and the compiled step over the state)."""
    cfg = get_config(arch).reduced()
    step = train_step.make_train_step(cfg, optimizer.OptConfig(lr=LR),
                                      **dict(dict(remat=False), **kw))
    state = fresh(cfg, kw.get("grad_compress", False))
    batches = [as_torch(batch_np(cfg, B=B, seed=i)) for i in range(STEPS)]
    graph = train_step.compile_train_step(step, state, batches[0],
                                          device="cpu")
    return cfg, step, state, batches, graph


def assert_jit_close(rnew, rmet, new, met, what):
    for k in ("nll", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                   rtol=RTOL_LOSS, err_msg=f"{what} {k}")
    assert int(new["step"]) == int(rnew["step"]) == 1
    assert new["step"].dtype == torch.int32
    assert_params_within(new["params"], rnew["params"], what=what)
    want, got = leaves_by_path(rnew["opt"]), leaves_by_path(new["opt"])
    assert sorted(want) == sorted(got)
    mus = [p for p in want if p.startswith("mu/")]
    assert len(mus) == len(leaves_by_path(rnew["params"]))
    err = norm = 0.0
    for path in mus:
        w, g = f32(want[path]), f32(got[path])
        assert got[path].dtype == torch.float32, path
        e, n = np.linalg.norm(g - w), np.linalg.norm(w)
        assert e <= JIT_MU_LEAF * n + 1e-12, f"{what} opt/{path}"
        err, norm = err + e * e, norm + n * n
    assert np.sqrt(err) <= RTOL_LOSS * np.sqrt(norm), f"{what} opt/mu"


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_train_graph_matches_the_jitted_reference(arch):
    """One step of the compiled body against the reference's step as
    `repro.launch.train` runs it, from the same state and batch."""
    cfg, _, state, batches, graph = compiled(arch)
    rstep = jax.jit(ref_ts.make_train_step(ref_get_config(arch).reduced(),
                                           ref_opt.OptConfig(lr=LR),
                                           remat=False))
    rnew, rmet = rstep(to_jax(from_torch(state)),
                       as_jax({k: v.numpy() for k, v in batches[0].items()}))
    host = from_torch(state)
    new, met = graph(state, batches[0])
    assert new is state and sorted(met) == sorted(rmet)
    if "expert_counts" in met and not np.array_equal(
            met["expert_counts"].numpy(), np.asarray(rmet["expert_counts"])):
        # XLA's fused roundings flipped an expert choice, and the router's
        # gradient with it (40% by norm for granite-moe-3b-a800m's first
        # layer): the step is held against the reference run op by op
        # instead, whose choices are the port's
        rnew, rmet = ref_ts.make_train_step(
            ref_get_config(arch).reduced(), ref_opt.OptConfig(lr=LR),
            remat=False)(to_jax(host), as_jax(
                {k: v.numpy() for k, v in batches[0].items()}))
        assert np.array_equal(met["expert_counts"].numpy(),
                              np.asarray(rmet["expert_counts"]))
        _assert_step_close((rnew, rmet), (new, met), f"{arch} (op by op)")
        return
    assert_jit_close(rnew, rmet, new, met, f"{arch} (jit)")


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_train_graph_equals_the_eager_step_bit_for_bit(option):
    """4 steps of the compiled body against the eager step run on a copy
    of the state: every leaf of the state and every metric bit-equal."""
    _, step, state, batches, graph = compiled(**OPTIONS[option])
    eager = tree_map(torch.clone, state)
    for batch in batches:
        eager, want = step(eager, batch)
        new, met = graph(state, batch)
        assert_trees_bit_equal(new, eager)
        assert sorted(met) == sorted(want)
        for k in want:
            assert torch.equal(met[k], want[k]), (option, k)


def test_state_comes_back_as_the_same_tensors():
    """The same state dict and the same tensor objects at every step, the
    metrics one dict of the same buffers, written in place."""
    _, _, state, batches, graph = compiled()
    leaves = tree_leaves_with_paths(state)
    seen = []
    for batch in batches:
        new, met = graph(state, batch)
        assert new is state
        assert all(a is b for (_, a), (_, b) in
                   zip(tree_leaves_with_paths(new), leaves))
        seen.append((met, {k: v.data_ptr() for k, v in met.items()}))
    assert all(m is seen[0][0] and ptrs == seen[0][1] for m, ptrs in seen)


def test_frozen_leaves_are_never_written():
    """A frozen leaf keeps its tensor, its address and its bits; every
    other parameter is written in place."""
    _, _, state, batches, graph = compiled(
        frozen=("params/layers/0", "embed"))
    before = {p: (t, t.data_ptr(), t.clone())
              for p, t in tree_leaves_with_paths(state["params"])}
    for batch in batches:
        graph(state, batch)
    for p, t in tree_leaves_with_paths(state["params"]):
        leaf, ptr, bits = before[p]
        assert t is leaf and t.data_ptr() == ptr, p
        frozen = p == "embed" or p.startswith("layers/0/")
        assert torch.equal(t, bits) == frozen, p


def test_step_counter_advances_on_the_device():
    _, _, state, batches, graph = compiled()
    counter = state["step"]
    for i, batch in enumerate(batches):
        graph(state, batch)
        assert state["step"] is counter
        assert counter.dtype == torch.int32 and counter.dim() == 0
        assert counter.device == batch["tokens"].device
        assert int(counter) == i + 1


def test_train_graph_refuses_another_state_or_batch():
    cfg, _, state, batches, graph = compiled()
    with pytest.raises(ValueError, match="other than"):
        graph(fresh(cfg), batches[0])
    with pytest.raises(ValueError, match="other than"):
        graph(dict(state, step=state["step"].clone()), batches[0])
    graph(dict(state), batches[0])        # another dict of the same tensors
    with pytest.raises(ValueError, match="tokens"):
        graph(state, as_torch(batch_np(cfg, B=4)))
    with pytest.raises(ValueError, match="keys"):
        graph(state, {"tokens": batches[0]["tokens"]})
    assert int(state["step"]) == 1


def test_compile_refuses_leaves_off_its_device():
    cfg, step, state, batches, _ = compiled()
    with pytest.raises(ValueError, match="neither"):
        train_step.compile_train_step(step, state, batches[0], device="meta")
    meta_batch = {k: v.to("meta") for k, v in batches[0].items()}
    with pytest.raises(ValueError, match="meta"):
        train_step.compile_train_step(step, state, meta_batch, device="cpu")
    state["params"]["final_norm"]["scale"] = \
        state["params"]["final_norm"]["scale"].to("meta")
    with pytest.raises(ValueError, match="meta"):
        train_step.compile_train_step(step, state, batches[0], device="cpu")


def test_compile_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path is tested on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_step.compile_train_step(lambda s, b: (s, {}), {}, {})
    with pytest.raises(RuntimeError):
        port_train.train("qwen1.5-0.5b", steps=1, log=False)


_DTENSOR = r"""
import json, torch
from torch.distributed.tensor import Replicate
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models.model import init_model_params
from repro_torch.parallel.sharding import from_local
from repro_torch.train import train_step
from repro_torch.train.optimizer import OptConfig
cfg = get_config("qwen1.5-0.5b").reduced()
params = init_model_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
state = train_step.init_train_state(cfg, params, OptConfig())
step = train_step.make_train_step(cfg, OptConfig(), remat=False)
batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
         "labels": torch.zeros((2, 8), dtype=torch.int32)}
with dryrun.fake_world(4):
    mesh = make_mesh_compat((2, 2), ("data", "model"), device_type="cpu")
    w = state["params"]["final_norm"]["scale"]
    state["params"]["final_norm"]["scale"] = from_local(
        w, mesh, [Replicate()] * 2, w.shape)
    try:
        train_step.compile_train_step(step, state, batch, device="cpu")
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


def test_train_steps_through_the_compiled_step(monkeypatch):
    """`train` compiles one step, after the static checker has traced the
    eager one, and hands back the state that step was compiled over."""
    order, built = [], []
    real_check = port_train.readonly_state_leaves

    def check(step_fn, *args):
        order.append("checker")
        return real_check(step_fn, *args)

    def spy(step_fn, state, batch, *, device):
        order.append("compile")
        built.append(train_step.compile_train_step(step_fn, state, batch,
                                                   device=device))
        return built[-1]

    monkeypatch.setattr(port_train, "readonly_state_leaves", check)
    monkeypatch.setattr(port_train, "compile_train_step", spy)
    res = port_train.train("qwen1.5-0.5b", steps=3, save_every=2,
                           global_batch=2, seq_len=16, async_save=False,
                           log=False, device="cpu")
    assert order == ["checker", "compile"] and len(built) == 1
    assert res["state"] is built[0].state and int(res["state"]["step"]) == 3
    res["chipmink"].close()


def test_async_save_commits_the_state_at_save_time():
    """An async save whose body is held back until the next step has
    overwritten the state in place commits the state as it was at
    `save()`, bit for bit (the snapshot rule), not the state the step
    left behind."""
    _, _, state, batches, graph = compiled()
    ck = Chipmink(MemoryStore(), LGA(), chunk_bytes=1 << 16, async_mode=True,
                  device="cpu")
    release = threading.Event()
    real_detect = ck.lineage.detector.detect

    def held(*args, **kw):
        assert release.wait(timeout=60)
        return real_detect(*args, **kw)

    ck.lineage.detector.detect = held
    graph(state, batches[0])
    want = tree_map(torch.clone, state)
    tid = ck.save({"params": state["params"], "opt": state["opt"],
                   "step": state["step"]})
    graph(state, batches[1])
    changed = tree_map(torch.clone, state)
    release.set()
    ck.wait()
    got = ck.load(time_id=tid)
    assert_trees_bit_equal(got, want)
    assert int(changed["step"]) == 2
    assert not torch.equal(changed["params"]["embed"],
                           want["params"]["embed"])
    ck.close()
