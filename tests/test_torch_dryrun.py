"""The port's dry-run (`repro_torch.launch.dryrun`): DTensor traces of the
step as rank 0 of a fake process group, on the CPU.

A process group is global to its process, so every body that starts one
runs in a subprocess of its own (the suite runs under xdist).  The traces
here are reduced configs at reduced shapes; the full-size cells run on the
card (`chip_smoke.py` phase 12).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch.dryrun import _WIRE_FACTOR, collectives_of

SRC = Path(__file__).resolve().parents[1] / "src"
FAMILIES = {"dense": "qwen1.5-0.5b", "moe": "granite-moe-3b-a800m",
            "ssm": "falcon-mamba-7b", "hybrid": "recurrentgemma-9b",
            "encdec": "whisper-base", "vlm": "qwen2-vl-2b"}


def _run(code: str, timeout: int = 60) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(l for l in out.stdout.splitlines() if l.startswith("JSON="))
    return json.loads(line[5:])


_TRACE = r"""
import dataclasses, json
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.parallel.sharding import set_rule_overrides
arch, shape, variant = "@ARCH@", "@SHAPE@", "@VARIANT@"
cfg = get_config(arch).reduced()
mesh_shape = ((2, 2), ("data", "model"))
cell = dataclasses.replace(SHAPES[shape], seq_len=64, global_batch=8)
r = dryrun.run_cell(arch, shape, device_type="cpu", save=False, cfg=cfg,
                    cell=cell, mesh_shape=mesh_shape, variant=variant)
with dryrun.fake_world(4):
    mesh = make_mesh_compat(*mesh_shape, device_type="cpu")
    set_rule_overrides(dryrun.VARIANTS[variant].get("rules"))
    _, args, shs = dryrun.build_cell(arch, shape, mesh, variant, cfg=cfg,
                                     cell=cell)
    spec_bytes = dryrun.spec_arg_bytes(args, shs)
print("JSON=" + json.dumps(dict(dataclasses.asdict(r), spec_bytes=spec_bytes)))
"""


def _trace(arch: str, shape: str, variant: str = "baseline") -> dict:
    return _run(_TRACE.replace("@ARCH@", arch).replace("@SHAPE@", shape)
                .replace("@VARIANT@", variant))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reduced_cell_traces_on_a_fake_2x2_mesh(family, shape):
    r = _trace(FAMILIES[family], shape)
    assert r["ok"], r["error"]
    assert r["mesh"] == "2x2" and r["chips"] == 4
    assert r["arg_bytes"] == r["spec_bytes"] > 0
    assert r["peak_bytes_per_device"] == (
        r["arg_bytes"] + r["out_bytes"] + r["temp_bytes"] - r["alias_bytes"])
    assert r["peak_bytes_per_device"] >= r["arg_bytes"]
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert r["model_flops"] > 0
    assert r["n_collectives"] == sum(
        c["count"] for c in r["collectives"].values())
    # a decode step writes its cache in place: the output holds the
    # input's storages; a train step returns a new state
    assert (r["alias_bytes"] > 0) == (shape == "decode_32k")


@pytest.mark.parametrize("arch,shape,variant", [
    ("granite-moe-3b-a800m", "train_4k", "ep_data+seq_sp+mixed"),
    ("qwen1.5-0.5b", "prefill_32k", "seq_sp+mixed"),
    ("granite-moe-3b-a800m", "decode_32k", "decode_repl2"),
    ("qwen1.5-0.5b", "decode_32k", "decode_repl")])
def test_variants_trace_on_a_fake_2x2_mesh(arch, shape, variant):
    """The hill-climb variants: expert parallelism over ``data``, the
    sequence-parallel residual, bf16 attention operands and the decode
    rule overrides."""
    r = _trace(arch, shape, variant)
    assert r["ok"], r["error"]
    assert r["arg_bytes"] == r["spec_bytes"] > 0


_FLOPS = r"""
import json, torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_compat
out = {}
with dryrun.fake_world(4):
    mesh = make_mesh_compat((4,), ("data",), device_type="cpu")
    def dt(shape, place):
        local = list(shape)
        if isinstance(place, Shard):
            local[place.dim] //= 4
        return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                                  [place], run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape,
                                                     device="meta").stride())
    w = dt((16, 32), Replicate())
    for name, x in (("sharded", dt((8, 16), Shard(0))),
                    ("replicated", dt((8, 16), Replicate()))):
        rec = dryrun.DeviceRecorder()
        with rec:
            torch.matmul(x, w)
        out[name] = rec.flops
print("JSON=" + json.dumps(out))
"""


def test_flops_count_the_local_shard():
    out = _run(_FLOPS)
    full = 2 * 8 * 16 * 32
    assert out["replicated"] == full
    assert out["sharded"] == full / 4


_COLLECTIVES = r"""
import json, torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_compat
with dryrun.fake_world(4):
    mesh = make_mesh_compat((4,), ("model",), device_type="cpu")
    x = DTensor.from_local(torch.empty(8, 4, device="meta"), mesh,
                           [Shard(1)], run_check=False)
    w = DTensor.from_local(torch.empty(4, 32, device="meta"), mesh,
                           [Shard(0)], run_check=False)
    rec = dryrun.DeviceRecorder()
    with rec:
        y = torch.matmul(x, w)              # contraction sharded: partial
        assert y.placements == (Partial(),), y.placements
        y.redistribute(mesh, [Replicate()])             # all-reduce
        y.redistribute(mesh, [Shard(0)])                # reduce-scatter
        z = DTensor.from_local(torch.empty(2, 32, device="meta"), mesh,
                               [Shard(0)], run_check=False)
        z.redistribute(mesh, [Replicate()])             # all-gather
print("JSON=" + json.dumps(dryrun.collectives_of(rec.collectives)))
"""


def test_collectives_of_a_known_program():
    colls = _run(_COLLECTIVES)
    y_bytes = 8 * 32 * 4
    assert [c["kind"] for c in colls] == ["all-reduce", "reduce-scatter",
                                          "all-gather"]
    assert [c["group"] for c in colls] == [4, 4, 4]
    assert [c["operand_bytes"] for c in colls] == [y_bytes, y_bytes,
                                                   2 * 32 * 4]
    assert [c["wire_bytes"] for c in colls] == [2 * y_bytes, y_bytes,
                                                2 * 32 * 4]


def test_collectives_of_names_the_reference_kinds():
    recs = [dict(op="all_gather_into_tensor", operand_bytes=64, group=16),
            dict(op="all_reduce", operand_bytes=100, group=8),
            dict(op="reduce_scatter_tensor", operand_bytes=32, group=2),
            dict(op="all_to_all_single", operand_bytes=48, group=4)]
    got = collectives_of(recs)
    assert [c["kind"] for c in got] == ["all-gather", "all-reduce",
                                        "reduce-scatter", "all-to-all"]
    for c in got:
        assert c["wire_bytes"] == _WIRE_FACTOR[c["kind"]] * \
            c["operand_bytes"]
    assert [c["group"] for c in got] == [16, 8, 2, 4]


_INPLACE = r"""
import dataclasses, json, torch
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models.model import api
from repro_torch.parallel.sharding import set_active_mesh
arch = "@ARCH@"
cfg = get_config(arch).reduced()
cell = dataclasses.replace(SHAPES["decode_32k"], seq_len=8, global_batch=4)
torch.manual_seed(0)
with dryrun.fake_world(1):
    mesh = make_mesh_compat((1, 1), ("data", "model"), device_type="cpu")
    set_active_mesh(mesh)
    step, args_abs, shs = dryrun.build_cell(arch, "decode_32k", mesh,
                                            cfg=cfg, cell=cell)
    gen = torch.Generator().manual_seed(0)
    params, cache, tok = dryrun.concrete_args(cfg, "decode", args_abs, shs,
                                              gen, "cpu")
    local = lambda t: {k: local(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.to_local()
    plain_params, plain_cache = local(params), local(cache)
    plain_cache = dryrun._map(lambda s, t: t.clone(),
                              args_abs[1], plain_cache)
    with implicit_replication():
        logits, new = step(params, cache, tok)
    set_active_mesh(None)
    want, want_cache = api(cfg).decode_step(plain_params, plain_cache,
                                            tok.to_local(), cfg)
    same = torch.equal(logits.to_local(), want)
    for path_k in new["layers"]:
        for k, t in new["layers"][path_k].items():
            same &= torch.equal(t.to_local(), want_cache["layers"][path_k][k])
            same &= t.to_local().data_ptr() == \
                cache["layers"][path_k][k].to_local().data_ptr()
print("JSON=" + json.dumps({"same": bool(same)}))
"""


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "falcon-mamba-7b",
                                  "recurrentgemma-9b", "whisper-base"])
def test_one_rank_dtensor_decode_equals_the_plain_step(arch):
    """On a (1, 1) mesh the DTensor step is the plain step, bit for bit,
    and writes the cache's own storages."""
    assert _run(_INPLACE.replace("@ARCH@", arch))["same"]
