"""The port's sharding rules (`repro_torch.parallel.sharding`), meshes and
abstract trees against the reference package, on the CPU.

Spec parity needs no process group: a duck-typed mesh whose ``shape`` is
a dict of axis sizes stands for the production meshes, as in the
reference's own rule tests.  The shard-order check runs JAX on 8 forced
host devices and DTensor on a fake process group of 8 ranks, each in a
subprocess of its own (a process group is global to the process).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.parallel import sharding as ref_sharding
from repro.train import optimizer as ref_optimizer
from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import mesh_chips
from repro_torch.models import model, transformer
from repro_torch.models.layers import TensorSpec
from repro_torch.parallel.sharding import (P, batch_spec, local_slices,
                                           placements_for, set_rule_overrides,
                                           spec_for, tree_shardings)
from repro_torch.train import optimizer

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """Duck-typed mesh with arbitrary axis sizes for rule unit tests."""

    def __init__(self, shape):
        self.shape = shape


# -- the reference's rule tests, against the port ----------------------------

def test_spec_divisibility():
    m = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert spec_for(m, ("vocab", "embed"), (152064, 1024)) == P("model", "data")
    assert spec_for(m, ("heads",), (40,)) == P(None)
    assert spec_for(m, ("heads",), (5120,)) == P("model")


def test_batch_spec_partial_axes():
    m = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert batch_spec(m, (256, 4096)) == P(("pod", "data"), None)
    assert batch_spec(m, (1, 128)) == P(None, None)
    assert batch_spec(m, (2, 8)) == P(("pod",), None)


def test_no_duplicate_axes():
    m = FakeMesh({"data": 16, "model": 16})
    sp = spec_for(m, ("vocab", "ffn"), (4096, 4096))
    axes = [a for a in sp if a is not None]
    assert axes.count("model") == 1


def test_rule_overrides():
    m = FakeMesh({"data": 16, "model": 16})
    try:
        set_rule_overrides({"embed": None})
        assert spec_for(m, ("embed",), (1024,)) == P(None)
        set_rule_overrides({"embed": "model"})
        assert spec_for(m, ("embed",), (1024,)) == P("model")
    finally:
        set_rule_overrides(None)


def test_tree_shardings():
    from torch.distributed.tensor import Replicate
    mesh = FakeMesh({"data": 1, "model": 1})
    sh = tree_shardings(mesh, {"w": TensorSpec((64, 32), torch.float32)},
                        {"w": ("embed", "ffn")})
    assert sh["w"].spec == P(None, None)  # 1-device mesh: all dropped
    assert list(sh["w"].placements) == [Replicate(), Replicate()]


def test_placements_of_a_dim_over_two_axes():
    from torch.distributed.tensor import Replicate, Shard
    m = FakeMesh({"pod": 2, "data": 16, "model": 16})
    spec = spec_for(m, ("batch", None, "vocab"), (256, 4, 4096))
    assert spec == P(("pod", "data"), None, "model")
    assert placements_for(m, spec) == [Shard(0), Shard(0), Shard(2)]
    with pytest.raises(ValueError, match="order"):
        placements_for(m, P(("data", "pod")))


# -- spec parity on every leaf of every full-size arch -----------------------

def _leaves(axes, abstract, prefix=()):
    if isinstance(axes, dict):
        for k in axes:
            yield from _leaves(axes[k], abstract[k], prefix + (k,))
    else:
        yield prefix, axes, tuple(abstract.shape)


def _ref_shape(tree, path):
    for k in path:
        tree = tree[k]
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_for_equals_reference_on_every_leaf(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    trees = []   # (name, axes, port abstract, reference abstract)
    p_axes = model.model_logical_axes(cfg)
    assert p_axes == ref_model.model_logical_axes(rcfg)
    p_abs = model.abstract_model_params(cfg)
    r_abs = ref_model.abstract_model_params(rcfg)
    trees.append(("params", p_axes, p_abs, r_abs))
    opt_cfg = dryrun._opt_for(cfg)
    o_axes = optimizer.opt_axes(p_axes, p_abs, opt_cfg)
    r_opt_cfg = ref_optimizer.OptConfig(name=opt_cfg.name)
    assert o_axes == ref_optimizer.opt_axes(p_axes, r_abs, r_opt_cfg)
    r_opt = jax.eval_shape(lambda p: ref_optimizer.opt_init(p, r_opt_cfg),
                           r_abs)
    trees.append(("opt", o_axes, dryrun._abstract(optimizer.opt_init(
        dryrun._map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), p_abs),
        opt_cfg)), r_opt))
    for shape in applicable_shapes(cfg):
        cell = SHAPES[shape]
        specs = model.input_specs(cfg, cell)
        r_specs = ref_model.input_specs(rcfg, REF_SHAPES[shape])
        if cell.kind == "decode":
            trees.append((shape + "/cache", transformer.cache_axes(cfg),
                          specs["cache"], r_specs["cache"]))
            specs = {"tokens": specs["tokens"]}
            r_specs = {"tokens": r_specs["tokens"]}
        else:
            specs, r_specs = specs["batch"], r_specs["batch"]
        for k, s in specs.items():
            for mesh in MESHES.values():
                m = FakeMesh(mesh)
                got = batch_spec(m, s.shape)
                want = ref_sharding.batch_spec(m, r_specs[k].shape)
                assert tuple(got) == tuple(want), (arch, shape, k)
    n = 0
    for name, axes, abstract, r_abstract in trees:
        for mesh_name, mesh in MESHES.items():
            m = FakeMesh(mesh)
            for path, ax, shp in _leaves(axes, abstract):
                assert shp == _ref_shape(r_abstract, path), (name, path)
                got = spec_for(m, ax, shp)
                want = ref_sharding.spec_for(m, ax, shp)
                assert tuple(got) == tuple(want), (name, mesh_name, path)
                placements_for(m, got)          # every spec has placements
                n += 1
    assert n > 0


# -- abstract trees, inputs, FLOPs -------------------------------------------

def _same_specs(port, ref, path=()):
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), path
        for k in port:
            _same_specs(port[k], ref[k], path + (k,))
        return
    assert tuple(port.shape) == tuple(ref.shape), path
    assert str(port.dtype).split(".")[-1] == str(np.dtype(ref.dtype)), path


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_trees_and_flops_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert model.count_params(cfg) == ref_model.count_params(rcfg)
    assert model.count_params(cfg, active_only=True) == \
        ref_model.count_params(rcfg, active_only=True)
    _same_specs(model.abstract_model_params(cfg),
                ref_model.abstract_model_params(rcfg))
    assert transformer.cache_axes(cfg) == ref_model.api(rcfg).cache_axes(rcfg)
    assert model.api(cfg).cache_axes is transformer.cache_axes
    for shape in applicable_shapes(cfg):
        assert model.model_flops(cfg, SHAPES[shape]) == \
            ref_model.model_flops(rcfg, REF_SHAPES[shape]), shape
        _same_specs(model.input_specs(cfg, SHAPES[shape]),
                    ref_model.input_specs(rcfg, REF_SHAPES[shape]))


def _bits(x):
    a = np.asarray(x)
    if a.dtype.itemsize == 2 and a.dtype.kind not in "iu":
        return a.view(np.uint16)
    return a


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-vl-2b",
                                  "whisper-base", "falcon-mamba-7b"])
def test_concrete_batch_bit_equal_at_reduced_size(arch):
    cfg, rcfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        small = dict(seq_len=16, global_batch=2)
        got = model.concrete_batch(
            cfg, dataclasses.replace(SHAPES[name], **small), seed=3)
        want = ref_model.concrete_batch(
            rcfg, dataclasses.replace(REF_SHAPES[name], **small), seed=3)
        flat_got = dryrun._locals(got)
        flat_want = jax.tree.leaves(want)
        assert len(flat_got) == len(flat_want)
        for g, w in zip(flat_got, flat_want):
            g = g.view(torch.uint16) if g.dtype == torch.bfloat16 else g
            assert np.array_equal(g.numpy(), _bits(w)), name


# -- per-device argument bytes of every cell ---------------------------------

_REF_ARG_BYTES = r"""
import json, sys
import jax, numpy as np
from repro.configs import ARCHS, applicable_shapes
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    name = "pod2x16x16" if mp else "pod16x16"
    for arch, cfg in ARCHS.items():
        for shape in applicable_shapes(cfg):
            _, args, shs = dryrun.build_cell(arch, shape, mesh)
            total = 0
            for a, s in zip(jax.tree.leaves(args), jax.tree.leaves(shs)):
                total += int(np.prod(s.shard_shape(a.shape))) \
                    * np.dtype(a.dtype).itemsize
            out[f"{arch}:{shape}:{name}"] = total
print("JSON=" + json.dumps({"bytes": out,
      "fields": [f.name for f in dryrun.dataclasses.fields(dryrun.CellResult)],
      "variants": sorted(dryrun.VARIANTS)}))
"""


def _jax_subprocess(code: str, n_devices: int, timeout: int = 60) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{n_devices}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=timeout, check=True)
    line = next(l for l in out.stdout.splitlines() if l.startswith("JSON="))
    return json.loads(line[5:])


def test_per_device_argument_bytes_equal_reference():
    ref = _jax_subprocess(_REF_ARG_BYTES, 512)
    assert [f.name for f in dataclasses.fields(dryrun.CellResult)] == \
        ref["fields"]
    assert sorted(dryrun.VARIANTS) == ref["variants"]
    n = 0
    for mesh_name, mesh in MESHES.items():
        m = FakeMesh(mesh)
        for arch, shape in dryrun.all_cells():
            _, args, shs = dryrun.build_cell(arch, shape, m)
            key = f"{arch}:{shape}:{mesh_name}"
            assert dryrun.spec_arg_bytes(args, shs) == ref["bytes"][key], key
            n += 1
    assert n == len(ref["bytes"])


# -- shard order over two mesh axes: port = DTensor = JAX --------------------

#: (global shape, spec) on the (pod=2, data=2, model=2) mesh
ORDER_CASES = [((8, 6), (("pod", "data"), None)),
               ((8, 8, 2), (("pod", "data", "model"), None, None)),
               ((8, 4), (("data", "model"), "pod")),
               ((6, 8), (None, ("pod", "model"))),
               ((4, 4, 4), ("model", "data", "pod"))]

_JAX_ORDER = r"""
import json
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.loads('CASES')
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
            ("pod", "data", "model"))
coords = {d.id: [int(i) for i in np.argwhere(mesh.devices == d)[0]]
          for d in mesh.devices.flat}
out = []
for shape, spec in cases:
    spec = [tuple(a) if isinstance(a, list) else a for a in spec]
    x = jax.device_put(np.arange(int(np.prod(shape))).reshape(shape),
                       NamedSharding(mesh, P(*spec)))
    out.append({json.dumps(coords[s.device.id]): np.asarray(s.data).tolist()
                for s in x.addressable_shards})
print("JSON=" + json.dumps(out))
"""

_DTENSOR_ORDER = r"""
import json, sys
import torch, torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.parallel.sharding import P, placements_for
cases = json.loads('CASES')
out = [dict() for _ in cases]
for rank in range(8):
    dist.init_process_group("fake", rank=rank, world_size=8, store=FakeStore())
    mesh = make_mesh_compat((2, 2, 2), ("pod", "data", "model"),
                            device_type="cpu")
    for i, (shape, spec) in enumerate(cases):
        spec = P(*[tuple(a) if isinstance(a, list) else a for a in spec])
        t = torch.arange(torch.Size(shape).numel()).reshape(shape)
        d = distribute_tensor(t, mesh, placements_for(mesh, spec),
                              src_data_rank=None)
        out[i][json.dumps(mesh.get_coordinate())] = d.to_local().tolist()
    dist.destroy_process_group()
print("JSON=" + json.dumps(out))
"""


def test_shard_order_equals_jax_on_a_two_axis_dim():
    cases = json.dumps([[list(s), [list(a) if isinstance(a, tuple) else a
                                   for a in sp]] for s, sp in ORDER_CASES])
    want = _jax_subprocess(_JAX_ORDER.replace("CASES", cases), 8)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", _DTENSOR_ORDER.replace("CASES", cases)],
        capture_output=True, text=True, env=env, timeout=60, check=True)
    got = json.loads(next(l for l in out.stdout.splitlines()
                          if l.startswith("JSON="))[5:])
    mesh = FakeMesh({"pod": 2, "data": 2, "model": 2})
    for (shape, spec), w, g in zip(ORDER_CASES, want, got):
        assert sorted(w) == sorted(g) and len(w) == 8
        full = np.arange(int(np.prod(shape))).reshape(shape)
        for coord, data in w.items():
            assert g[coord] == data, (shape, spec, coord)
            mine = full[local_slices(shape, mesh, P(*spec), json.loads(coord))]
            assert mine.tolist() == data, (shape, spec, coord)


def test_mesh_module_needs_a_world_of_the_mesh_size():
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="repro_torch.launch.dryrun"):
        mesh.make_production_mesh(multi_pod=True)
    assert mesh_chips(FakeMesh({"pod": 2, "data": 16, "model": 16})) == 512
