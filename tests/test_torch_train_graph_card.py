"""The compiled train step (`repro_torch.train.train_step.
compile_train_step`) on a card, at the reduced configs of every family
the trainer takes and with each option of `make_train_step`: the capture
leaves the state bit-equal, and the graph replays the eager step.

This file imports no JAX and nothing of the reference, so it runs where
the card is: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_train_graph_card.py``.  Without a card every test skips
through the `cuda` fixture; the graph's body, which the CPU runs eagerly,
is held against the reference in `test_torch_train_graph.py`.

Tolerance: bit-equal wherever two eager runs of the same step are
bit-equal to each other; where they are not (a kernel that sums in a
run-dependent order), every element of the graph's tensors no further
from the first eager run than twice the second eager run is from it.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import batch_on
from repro_torch.models import model, transformer
from repro_torch.train import train_step
from repro_torch.train.data import TokenPipeline
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.tree import tree_leaves_with_paths, tree_map

#: (arch, make_train_step options): the trainer's families (dense, MoE,
#: SSM, hybrid), then each option on the dense model
CASES = {
    "dense": ("qwen1.5-0.5b", {}),
    "moe": ("granite-moe-3b-a800m", {}),
    "ssm": ("falcon-mamba-7b", {}),
    "hybrid": ("recurrentgemma-9b", {}),
    "remat": ("qwen1.5-0.5b", dict(remat=True)),
    "microbatches": ("qwen1.5-0.5b", dict(microbatches=2)),
    "grad_compress": ("qwen1.5-0.5b", dict(grad_compress=True)),
    "frozen": ("qwen1.5-0.5b", dict(frozen=("params/embed",
                                             "params/layers/0"))),
}
B, S, STEPS = 4, 32, 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode (its "
                    "body is tested in test_torch_train_graph.py)")
    return torch.device("cuda")


def start(arch, cuda, **kw):
    """(cfg, eager step, a state one eager step past its init, batches)."""
    cfg = get_config(arch).reduced()
    opt_cfg = OptConfig(lr=1e-3)
    params = model.init_model_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    state = train_step.init_train_state(
        cfg, params, opt_cfg, grad_compress=kw.get("grad_compress", False))
    step = train_step.make_train_step(cfg, opt_cfg,
                                      **dict(dict(remat=False), **kw))
    pipe = TokenPipeline(cfg.vocab, B, S)
    batches = [batch_on(pipe.next_batch(), cuda) for _ in range(STEPS + 1)]
    state, _ = step(state, batches.pop())
    return cfg, step, state, batches


def compile_strict(step, state, batch, cuda):
    torch.cuda.set_sync_debug_mode("error")     # no host sync in the step
    try:
        return train_step.compile_train_step(step, state, batch, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def flat(state, metrics):
    return dict(tree_leaves_with_paths({"state": state,
                                        "metrics": metrics}))


@pytest.mark.parametrize("case", sorted(CASES))
def test_capture_leaves_the_state_and_replays_the_eager_step(cuda, case):
    """The state is bit-equal after `compile_train_step` to what it was
    before; then 3 replays against the eager step on two copies of the
    state, with equal batches: every leaf of the state and every metric
    bit-equal to the first copy where the two eager runs are bit-equal,
    else within the module's rule.  A frozen leaf is never written: the
    same tensor, its bits and its address."""
    arch, kw = CASES[case]
    _, step, state, batches = start(arch, cuda, **kw)
    copies = [tree_map(torch.clone, state) for _ in range(2)]
    before = flat(tree_map(torch.clone, state), {})
    graph = compile_strict(step, state, batches[0], cuda)
    torch.cuda.synchronize()
    assert graph.graph is not None
    for path, leaf in flat(state, {}).items():
        assert torch.equal(leaf, before[path]), path
    frozen = {p: (t, t.data_ptr()) for p, t in flat(state, {}).items()
              if p.startswith(("state/params/embed",
                               "state/params/layers/0/"))
              and kw.get("frozen")}
    for i, batch in enumerate(batches):
        eager = []
        for j, c in enumerate(copies):
            copies[j], met = step(c, batch)
            eager.append(flat(copies[j], met))
        torch.cuda.set_sync_debug_mode("error")
        try:
            new, metrics = graph(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert new is state and int(state["step"]) == i + 2
        got = flat(state, metrics)
        assert sorted(got) == sorted(eager[0])
        stable = all(torch.equal(eager[0][p], eager[1][p]) for p in got)
        for path, t in got.items():
            what = f"{case} step {i} {path}"
            a, b = eager[0][path], eager[1][path]
            if stable:
                assert torch.equal(t, a), what
            elif not torch.equal(t, a):
                spread = (a.double() - b.double()).abs().max()
                assert (t.double() - a.double()).abs().max() <= 2 * spread, \
                    what
    for path, (t, ptr) in frozen.items():
        assert flat(state, {})[path] is t and t.data_ptr() == ptr, path
        assert torch.equal(t, before[path]), path


def test_capture_raises_on_a_host_sync(cuda, monkeypatch):
    """A step that syncs with the host cannot be captured: the capture
    raises, nothing runs the step eagerly in its place, and the state is
    left as it was."""
    real = transformer.loss_fn

    def syncing(*args, **kw):
        loss, metrics = real(*args, **kw)
        float(loss)                              # a device->host read
        return loss, metrics

    monkeypatch.setattr(transformer, "loss_fn", syncing)
    _, step, state, batches = start("qwen1.5-0.5b", cuda)
    before = flat(tree_map(torch.clone, state), {})
    with pytest.raises(RuntimeError):
        train_step.compile_train_step(step, state, batches[0], device=cuda)
    for path, leaf in flat(state, {}).items():
        assert torch.equal(leaf, before[path]), path
