"""Elastic restore and the compressed psum of the port on 4 gloo ranks,
held bit-exact against the reference package on the CPU, and the
dry-run's steps run for real on those ranks.

Each distributed body runs in a subprocess of its own that spawns the 4
ranks (`torch.multiprocessing.spawn`): a process group is global to its
process and the suite runs under xdist.  The restored state comes from a
store that the reference package wrote.
"""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.core import Chipmink as RefChipmink
from repro.core import FileStore as RefFileStore
from repro.launch.mesh import make_local_mesh as ref_local_mesh
from repro.models.model import init_model_params as ref_init_params
from repro.models.model import model_logical_axes as ref_axes
from repro.runtime.fault_tolerance import elastic_restore as ref_restore
from repro.train import grad_compress as ref_gc

SRC = Path(__file__).resolve().parents[1] / "src"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(tmp_path: Path, body: str, *args: str) -> str:
    """Run `body` (defining ``run(rank, *args)``) on 4 gloo ranks."""
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        import torch.distributed as dist
        import torch.multiprocessing as mp

        def setup(rank, port):
            dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                    rank=rank, world_size=4)
    """) + textwrap.dedent(body) + textwrap.dedent("""
        def main(rank, port, *args):
            setup(rank, port)
            try:
                run(rank, *args)
            finally:
                dist.destroy_process_group()

        if __name__ == "__main__":
            mp.spawn(main, args=(int(sys.argv[1]), *sys.argv[2:]), nprocs=4)
            print("ALL RANKS OK")
    """))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), str(_free_port()),
                          *args], capture_output=True, text=True, env=env,
                         timeout=60)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "ALL RANKS OK" in out.stdout
    return out.stdout


_RESTORE = """
    from repro_torch.configs import get_config
    from repro_torch.core import Chipmink, FileStore
    from repro_torch.launch.mesh import make_local_mesh, make_mesh_compat
    from repro_torch.models.model import model_logical_axes
    from repro_torch.parallel.sharding import (local_slices,
                                               placements_for, spec_for)
    from repro_torch.runtime.fault_tolerance import elastic_restore
    from repro_torch.train.tree import tree_leaves_with_paths

    def flat(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, pre + k + "/")
            else:
                yield pre + k, v

    def run(rank, store, want):
        cfg = get_config("qwen1.5-0.5b").reduced()
        want = np.load(want)
        # every rank reads the manifest and holds the whole state
        loaded = Chipmink(FileStore(store), device="cpu").load(
            names={"params"})["params"]
        axes = dict(flat(model_logical_axes(cfg)))
        for mesh in (make_mesh_compat((2, 2), ("data", "model"),
                                      device_type="cpu"),
                     make_local_mesh(device_type="cpu")):
            restored = elastic_restore(loaded, mesh, model_logical_axes(cfg))
            full = dict(tree_leaves_with_paths(loaded))
            n_sharded = 0
            for path, d in tree_leaves_with_paths(restored):
                t = full[path]
                spec = spec_for(mesh, axes[path], t.shape)
                assert list(d.placements) == placements_for(mesh, spec), path
                assert torch.equal(d.to_local(),
                                   t[local_slices(t.shape, mesh, spec)]), path
                n_sharded += d.to_local().numel() < t.numel()
                g = d.full_tensor()
                bits = g.view(torch.uint16) if g.dtype == torch.bfloat16 \\
                    else g.view(torch.int32)
                assert np.array_equal(bits.numpy(), want[path]), path
            assert n_sharded > 0
"""


def test_elastic_restore_on_four_gloo_ranks(tmp_path):
    rcfg = ref_get_config("qwen1.5-0.5b").reduced()
    params = jax.tree.map(np.asarray, ref_init_params(rcfg,
                                                      jax.random.key(0)))
    store = tmp_path / "store"
    ck = RefChipmink(RefFileStore(str(store)), chunk_bytes=1 << 12)
    ck.save({"params": params})
    loaded = RefChipmink(RefFileStore(str(store)), chunk_bytes=1 << 12) \
        .load(names={"params"})["params"]
    restored = ref_restore(loaded, ref_local_mesh(), ref_axes(rcfg))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(restored):
        key = "/".join(p.key for p in path)
        a = np.asarray(leaf)
        want[key] = a.view(np.uint16) if a.dtype.itemsize == 2 \
            else a.view(np.int32)
    np.savez(tmp_path / "want.npz", **want)
    _spawn(tmp_path, _RESTORE, str(store), str(tmp_path / "want.npz"))


_PSUM = """
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.train.grad_compress import compressed_psum

    def run(rank, data):
        d = np.load(data)
        x = torch.from_numpy(d["x"][rank])
        got = compressed_psum(x)                       # the default group
        assert np.array_equal(got.numpy().view(np.uint32),
                              d["world"].view(np.uint32))
        mesh = make_mesh_compat((2, 2), ("data", "model"), device_type="cpu")
        got = compressed_psum(x, mesh.get_group("data"))
        assert np.array_equal(got.numpy().view(np.uint32),
                              d["data"][rank].view(np.uint32))
        bf = compressed_psum(x.to(torch.bfloat16))
        assert bf.dtype == torch.bfloat16 and bf.shape == x.shape
"""


def _ref_psum(xs):
    """The reference's arithmetic: int32 sum of `quantize`'s payloads times
    the largest scale, over the ranks of `xs`."""
    qs, ss = [], []
    for x in xs:
        q, s, n = ref_gc.quantize(jnp.asarray(x))
        qs.append(np.asarray(q).astype(np.int32))
        ss.append(np.asarray(s))
    acc = np.sum(qs, axis=0, dtype=np.int32)
    out = (acc.astype(np.float32) * np.max(ss, axis=0)).reshape(-1)[:n]
    return out.reshape(xs[0].shape)


def test_compressed_psum_on_four_gloo_ranks(tmp_path):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 37, 29)).astype(np.float32) \
        * np.array([1, 3, 0.5, 8], np.float32)[:, None, None]
    # (data, model) = (2, 2): rank = 2 * data + model; the data group of
    # a rank holds the ranks with its model coordinate
    data = np.stack([_ref_psum([x[r % 2], x[r % 2 + 2]]) for r in range(4)])
    np.savez(tmp_path / "psum.npz", x=x, world=_ref_psum(list(x)), data=data)
    _spawn(tmp_path, _PSUM, str(tmp_path / "psum.npz"))


_STEPS = """
    import dataclasses
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.parallel.sharding import set_active_mesh

    #: the model tests' bf16 tolerance.  A sharded contraction rounds each
    #: rank's partial sum to bf16 before the ranks' sum, and the extra
    #: roundings compound by layer (up to 0.0625, one bf16 ulp at 8, in
    #: recurrentgemma's 3-layer prefill logits), so every element is held
    #: within four times it and 98% of each tensor within it; a wrong
    #: shard or offset is off by O(1) across whole rows
    TOL = dict(rtol=2e-2, atol=2e-2)
    TOL_ALL = dict(rtol=8e-2, atol=8e-2)

    def full(tree):
        if isinstance(tree, dict):
            return {k: full(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(full(v) for v in tree)
        return tree.full_tensor() if hasattr(tree, "full_tensor") else tree

    def close(got, want, what):
        if isinstance(want, dict):
            for k in want:
                close(got[k], want[k], what + "/" + k)
            return
        got, want = got.float(), want.float()
        torch.testing.assert_close(got, want, **TOL_ALL, msg=what)
        within = (got - want).abs() <= TOL["atol"] + TOL["rtol"] * want.abs()
        assert within.float().mean() >= 0.98, what

    def run(rank, arch):
        cfg = get_config(arch).reduced()
        mesh = make_mesh_compat((2, 2), ("data", "model"), device_type="cpu")
        for shape in ("decode_32k", "prefill_32k", "train_4k"):
            cell = dataclasses.replace(SHAPES[shape], seq_len=16,
                                       global_batch=4)
            set_active_mesh(mesh)
            step, abs_, shs = dryrun.build_cell(arch, shape, mesh, cfg=cfg,
                                                cell=cell)
            gen = torch.Generator().manual_seed(0)  # the same on every rank
            args = dryrun.concrete_args(cfg, cell.kind, abs_, shs, gen, "cpu")
            plain = full(args)
            with implicit_replication():
                out = step(*args)
            set_active_mesh(None)
            want = step(*plain)
            if shape == "decode_32k":
                close(full(out[0]), want[0], shape + " logits")
                close(full(out[1]["layers"]), want[1]["layers"],
                      shape + " cache")
                # the cache was written in place, shard by shard
                close(full(args[1]["layers"]), want[1]["layers"],
                      shape + " cache in place")
            elif shape == "prefill_32k":
                close(full(out), want, shape)
            else:
                close(full(out[1]["nll"]), want[1]["nll"], "loss")
                close(full(out[0]["params"]), want[0]["params"], "params")
"""


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m",
                                  "falcon-mamba-7b", "recurrentgemma-9b"])
def test_sharded_steps_equal_the_plain_steps_on_four_gloo_ranks(tmp_path,
                                                                arch):
    """The steps the dry-run traces, run for real on a (2, 2) mesh of 4
    gloo ranks (DTensors: sharded matmuls, the vocab-parallel embedding
    and cross-entropy, sequence-parallel attention, cache slots written
    shard by shard), agree with the same step on whole tensors within the
    bf16 tolerance stated in the worker."""
    _spawn(tmp_path, _STEPS, arch)
