"""Multi-pod dry-run: trace every (architecture x input shape x mesh) cell
as one rank of the production mesh, prove memory fit, and extract roofline
terms.  The port of `repro.launch.dryrun`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \
        --shape train_4k [--multi-pod] [--device-type cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference lowers and compiles each cell with XLA on 512 host devices.
Here a cell runs once as rank 0 of a fake process group
(`torch.testing._internal.distributed.fake_pg`) of the mesh's size: the
state is built as `DTensor`s with the sharding rules' placements
(`parallel/sharding.py`) whose shards are meta tensors, so nothing is
allocated and no collective moves data, and the step (train, prefill or
decode, as `build_cell` makes it) runs eagerly on them.  (A
`FakeTensorMode` would do the same, but DTensor's placement helpers of
some releases read index tensors on the host, which a fake mode
refuses.)  A dispatch mode below DTensor sees every local aten op of
rank 0 and keeps:

  * peak bytes per device: the live storages of rank 0's local tensors
    (each DTensor counts its local shard; views share their storage, so
    the in-place cache counts once), at its highest during the step;
    `arg_bytes` the inputs, `out_bytes` the outputs' storages that are not
    inputs', `alias_bytes` the outputs' storages that are inputs' (the
    cache a decode step writes in place: torch has no donation, so a train
    step's new state counts beside the old one), and
    ``temp_bytes = peak - arg - out + alias``, the reference's split;
  * flops per device: rank 0's local matmul flops
    (`torch.utils.flop_counter`'s formulas on local shapes), so a
    batch-sharded matmul on 4 ranks counts a quarter and a replicated one
    the whole;
  * bytes per device: the operand and result bytes of every local aten op.
    Eager ops are unfused, so this is an upper bound of XLA's fused
    "bytes accessed";
  * collectives: the `_c10d_functional` ops DTensor issues, each with its
    kind under the reference's names, per-device operand bytes, group
    size and wire bytes (`collectives_of`).

``compile_s`` holds the trace's seconds.  Per cell this writes
experiments/dryrun_torch/<arch>__<shape>__<mesh>[__variant].json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import weakref
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, SHAPES, ShapeCell, applicable_shapes, get_config
from ..models.layers import TensorSpec
from ..models.model import (abstract_model_params, api, count_params,
                            input_specs, model_flops, model_logical_axes)
from ..parallel.sharding import (distribute, from_local, local_shape,
                                 named_sharding, set_active_mesh,
                                 set_rule_overrides, tree_shardings)
from ..train.optimizer import OptConfig, opt_axes, opt_init
from ..train.serve_step import make_decode_step, make_prefill_step
from ..train.train_step import make_train_step
from .mesh import make_mesh_compat, make_production_mesh

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "experiments", "dryrun_torch")

#: wire bytes per device ≈ factor × per-device operand bytes (ring)
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
#: `_c10d_functional` op -> the reference's collective kind
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "all_to_all_single": "all-to-all"}


def collectives_of(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The reference's `parse_collectives` dicts (kind, per-device operand
    bytes, group size, wire bytes) from the recorder's collective records
    (op name, operand bytes, group).  `parse_collectives` reads XLA's
    partitioned HLO text, which torch does not produce; this takes its
    place."""
    out = []
    for r in records:
        kind = _KINDS[r["op"]]
        out.append({"kind": kind, "operand_bytes": r["operand_bytes"],
                    "group": r["group"],
                    "wire_bytes": _WIRE_FACTOR[kind] * r["operand_bytes"]})
    return out


def _group_size(args: tuple) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = next(a for a in reversed(args) if isinstance(a, str))
    return _resolve_process_group(name).size()


class DeviceRecorder(TorchDispatchMode):
    """Rank 0's local aten ops under DTensor: matmul flops, operand and
    result bytes, `_c10d_functional` collectives, and the live bytes of
    the storages its tensors hold (inputs registered with `hold`), with
    their peak."""

    def __init__(self) -> None:
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.collectives: List[Dict[str, Any]] = []
        self.live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak = 0

    def hold(self, t: torch.Tensor) -> int:
        """Count `t`'s storage live until it is freed; returns its key."""
        st = t.untyped_storage()
        key = st._cdata
        if key not in self.live:
            n = st.nbytes()
            self.live[key] = n
            self.live_bytes += n
            self.peak = max(self.peak, self.live_bytes)
            weakref.finalize(st, self._free, key)
        return key

    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor run its local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor's sharding propagation runs each op once on fake
            # global-shape tensors (in a FakeTensorMode) to learn its
            # output's metadata: that is no rank's work
            return out
        packet = func.overloadpacket
        tensors_in = [a for a in torch.utils._pytree.tree_leaves(
            (args, kwargs)) if isinstance(a, torch.Tensor)]
        tensors_out = [o for o in torch.utils._pytree.tree_leaves(out)
                       if isinstance(o, torch.Tensor)]
        self.n_ops += 1
        self.bytes += sum(t.numel() * t.element_size()
                          for t in tensors_in + tensors_out)
        if packet in self._flops_of:
            self.flops += float(self._flops_of[packet](
                *args, **kwargs, out_val=out))
        name = packet.__name__
        if func.namespace == "_c10d_functional" and name in _KINDS:
            self.collectives.append(dict(
                op=name, group=_group_size(args),
                operand_bytes=sum(t.numel() * t.element_size()
                                  for t in tensors_in)))
        for t in tensors_out:
            self.hold(t)
        return out


@dataclasses.dataclass
class CellResult:
    """One cell's dry-run.  ``compile_s`` is the trace's seconds (the
    reference's lower-and-compile)."""
    arch: str
    shape: str
    mesh: str
    chips: int
    ok: bool
    error: Optional[str] = None
    compile_s: float = 0.0
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    arg_bytes: int = 0
    out_bytes: int = 0
    temp_bytes: int = 0
    alias_bytes: int = 0
    peak_bytes_per_device: int = 0
    collective_wire_bytes: float = 0.0
    collectives: Optional[Dict[str, Dict[str, float]]] = None
    model_flops: float = 0.0
    n_collectives: int = 0


def _opt_for(cfg) -> OptConfig:
    n = count_params(cfg)
    # factored optimizer for >=100B params (memory fit)
    return OptConfig(name="adafactor" if n > 100e9 else "adamw")


#: the reference's hill-climb variants: cfg transform + rule overrides
def _vt_ep_data(cfg):
    return dataclasses.replace(cfg, ep_axis="data")


def _vt_mixed_attn(cfg):
    return dataclasses.replace(cfg, mixed_attn=True)


def _vt_seq_sp(cfg):
    return dataclasses.replace(cfg, seq_sp=True)


VARIANTS: Dict[str, Dict[str, Any]] = {
    "baseline": {},
    "ep_data": {"cfg": _vt_ep_data},
    "mixed_attn": {"cfg": _vt_mixed_attn},
    "seq_sp": {"cfg": _vt_seq_sp},
    "seq_sp+mixed": {"cfg": lambda c: _vt_mixed_attn(_vt_seq_sp(c))},
    "ep_data+mixed": {"cfg": lambda c: _vt_mixed_attn(_vt_ep_data(c))},
    "ep_data+seq_sp+mixed": {
        "cfg": lambda c: _vt_mixed_attn(_vt_seq_sp(_vt_ep_data(c)))},
    "decode_repl": {"rules": {"embed": None}},  # weights-resident serving
    # decode for archs whose expert/head counts don't divide the mesh:
    # shard the embed dim over `model` instead
    "decode_repl2": {"rules": {"embed": "model"}},
}


def _map(fn, tree: Any, *rest: Any) -> Any:
    """`fn` over the `TensorSpec` leaves of `tree` (and the matching
    subtrees of `rest`)."""
    if isinstance(tree, TensorSpec):
        return fn(tree, *rest)
    return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}


def _batch_shardings(mesh, batch_abs: Dict) -> Dict:
    return _map(lambda s: named_sharding(
        mesh, ("batch",) + (None,) * (len(s.shape) - 1), s.shape), batch_abs)


def build_cell(arch_id: str, shape_name: str, mesh,
               variant: str = "baseline", *, cfg=None,
               cell: Optional[ShapeCell] = None) -> Tuple[Any, tuple, tuple]:
    """Returns (step_fn, example_args_abstract, in_shardings_tree): the
    abstract args are `TensorSpec` trees, the shardings `NamedSharding`
    trees of the same structure.  `cfg` and `cell` replace the arch's
    config and the shape's cell (reduced ones in the tests)."""
    cfg = cfg or get_config(arch_id)
    spec = VARIANTS[variant]
    if "cfg" in spec:
        cfg = spec["cfg"](cfg)
    cell = cell or SHAPES[shape_name]
    m = api(cfg)
    params_abs = abstract_model_params(cfg)
    p_axes = model_logical_axes(cfg)
    params_sh = tree_shardings(mesh, params_abs, p_axes)
    specs = input_specs(cfg, cell)

    if cell.kind == "train":
        opt_cfg = _opt_for(cfg)
        meta = _map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), params_abs)
        opt_abs = _abstract(opt_init(meta, opt_cfg))
        o_axes = opt_axes(p_axes, params_abs, opt_cfg)
        state_abs = {"params": params_abs, "opt": opt_abs,
                     "step": TensorSpec((), torch.int32)}
        state_axes = {"params": p_axes, "opt": o_axes, "step": ()}
        state_sh = tree_shardings(mesh, state_abs, state_axes)
        batch_abs = specs["batch"]
        batch_sh = _batch_shardings(mesh, batch_abs)
        # microbatching bounds per-device live activations; the giant MoE
        # accumulates its microbatches in bf16
        micro, accum = 1, torch.float32
        if cfg.arch_id == "kimi-k2-1t-a32b":
            micro, accum = 8, torch.bfloat16
        step = make_train_step(cfg, opt_cfg, microbatches=micro,
                               accum_dtype=accum,
                               q_chunk=None if cell.seq_len <= 4096
                               else 2048)
        return step, (state_abs, batch_abs), (state_sh, batch_sh)

    if cell.kind == "prefill":
        step = make_prefill_step(cfg, q_chunk=max(2048, cell.seq_len // 4))
        batch_abs = specs["batch"]
        return step, (params_abs, batch_abs), \
            (params_sh, _batch_shardings(mesh, batch_abs))

    # decode
    step = make_decode_step(cfg)
    cache_abs = specs["cache"]
    cache_sh = tree_shardings(mesh, cache_abs, m.cache_axes(cfg))
    tok_abs = specs["tokens"]
    tok_sh = named_sharding(mesh, ("batch", None), tok_abs.shape)
    return step, (params_abs, cache_abs, tok_abs), \
        (params_sh, cache_sh, tok_sh)


def _abstract(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _abstract(v) for k, v in tree.items()}
    return TensorSpec(tuple(tree.shape), tree.dtype)


def spec_arg_bytes(args_abs: tuple, shardings: tuple) -> int:
    """Bytes of one device's shards of the args, from the specs alone."""
    total = 0

    def add(s: TensorSpec, sh) -> None:
        nonlocal total
        total += math.prod(local_shape(s.shape, sh.mesh, sh.spec)) \
            * s.dtype.itemsize

    for a, sh in zip(args_abs, shardings):
        _map(add, a, sh)
    return total


def abstract_args(args_abs: tuple, shardings: tuple) -> tuple:
    """DTensors of the abstract args, each holding its local shard as a
    meta tensor (allocates nothing)."""
    def leaf(s: TensorSpec, sh) -> Any:
        local = torch.empty(local_shape(s.shape, sh.mesh, sh.spec),
                            dtype=s.dtype, device="meta")
        return from_local(local, sh.mesh, sh.placements, s.shape)
    return tuple(_map(leaf, a, s) for a, s in zip(args_abs, shardings))


def concrete_args(cfg, kind: str, args_abs: tuple, shardings: tuple,
                  generator: torch.Generator, device: Any) -> tuple:
    """Real DTensors for `build_cell`'s args: random parameters from
    `init_model_params`, zero optimizer state and caches (as `opt_init`
    and `init_cache` start them), tokens drawn below the vocab, floats of
    a batch drawn from a normal."""
    from ..models.model import init_model_params
    params = init_model_params(cfg, generator, device=device)

    def leaf(s: TensorSpec, sh) -> Any:
        if s.dtype.is_floating_point:
            t = torch.zeros(s.shape, dtype=s.dtype, device=device)
        elif s.shape:
            t = torch.randint(0, cfg.vocab, s.shape, generator=generator,
                              device=device, dtype=s.dtype)
        else:
            t = torch.zeros((), dtype=s.dtype, device=device)
        return distribute(t, sh)

    def tree(p: Any, a: Any, sh: Any) -> Any:
        return _map(lambda s, h, x: distribute(x, h), a, sh, p)

    if kind == "train":
        state, batch = args_abs
        sh_state, sh_batch = shardings
        out_state = {k: _map(leaf, state[k], sh_state[k])
                     for k in state if k != "params"}
        out_state["params"] = tree(params, state["params"],
                                   sh_state["params"])
        return out_state, _map(leaf, batch, sh_batch)
    rest = tuple(_map(leaf, a, sh)
                 for a, sh in zip(args_abs[1:], shardings[1:]))
    return (tree(params, args_abs[0], shardings[0]),) + rest


def _locals(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _locals(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _locals(v)]
    if isinstance(tree, torch.Tensor):
        return [tree.to_local() if hasattr(tree, "to_local") else tree]
    return []


def _storage_bytes(tensors: List[torch.Tensor]) -> Dict[int, int]:
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tensors}


def trace_cell(step, args: tuple, recorder: DeviceRecorder) -> Dict[str, int]:
    """Run `step(*args)` once under `recorder` (and, for DTensor args,
    implicit replication of plain tensors the step creates).  Returns
    the per-device byte split."""
    from torch.distributed.tensor.experimental import implicit_replication
    ins = _storage_bytes(_locals(args))
    for t in _locals(args):
        recorder.hold(t)
    with implicit_replication(), recorder:
        out = step(*args)
    outs = _storage_bytes(_locals(out))
    arg = sum(ins.values())
    alias = sum(n for k, n in outs.items() if k in ins)
    out_b = sum(n for k, n in outs.items() if k not in ins)
    del out
    return dict(arg_bytes=arg, out_bytes=out_b, alias_bytes=alias,
                temp_bytes=recorder.peak - arg - out_b + alias,
                peak_bytes_per_device=recorder.peak)


#: mesh name -> (shape, axis names): the production meshes, and one card's
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "local1x1": ((1, 1), ("data", "model"))}


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of `world_size` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
             save: bool = True, variant: str = "baseline",
             device_type: str = "cuda", mesh: Optional[str] = None,
             mesh_shape: Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]]
             = None, cfg=None, cell: Optional[ShapeCell] = None
             ) -> CellResult:
    """Trace one cell as rank 0 of a fake process group, on the production
    mesh (``multi_pod`` picks which), on the `MESHES` entry `mesh`, or on
    `mesh_shape`, a (shape, axis names) pair.  A cell that fails is
    reported with ``ok=False`` and its error.  `cfg` and `cell` replace
    the arch's config and the shape's cell."""
    if mesh_shape is None:
        mesh = mesh or ("pod2x16x16" if multi_pod else "pod16x16")
        mesh_shape = MESHES[mesh]
    mesh_name = mesh or "x".join(map(str, mesh_shape[0]))
    chips = math.prod(mesh_shape[0])
    cell = cell or SHAPES[shape_name]
    res = CellResult(arch=arch_id, shape=shape_name, mesh=mesh_name,
                     chips=chips, ok=False,
                     model_flops=model_flops(cfg or get_config(arch_id),
                                             cell))
    t0 = time.time()
    with fake_world(chips):
        try:
            if mesh_name in ("pod16x16", "pod2x16x16"):
                dmesh = make_production_mesh(
                    multi_pod=mesh_name == "pod2x16x16",
                    device_type=device_type)
            else:
                dmesh = make_mesh_compat(*mesh_shape,
                                         device_type=device_type)
            set_active_mesh(dmesh)
            set_rule_overrides(VARIANTS[variant].get("rules"))
            step, args_abs, shardings = build_cell(
                arch_id, shape_name, dmesh, variant=variant, cfg=cfg,
                cell=cell)
            recorder = DeviceRecorder()
            split = trace_cell(step, abstract_args(args_abs, shardings),
                               recorder)
            res.compile_s = time.time() - t0
            for k, v in split.items():
                setattr(res, k, int(v))
            res.flops_per_device = recorder.flops
            res.bytes_per_device = recorder.bytes
            colls = collectives_of(recorder.collectives)
            agg: Dict[str, Dict[str, float]] = defaultdict(
                lambda: {"count": 0, "operand_bytes": 0.0,
                         "wire_bytes": 0.0})
            for c in colls:
                a = agg[c["kind"]]
                a["count"] += 1
                a["operand_bytes"] += c["operand_bytes"]
                a["wire_bytes"] += c["wire_bytes"]
            res.collectives = dict(agg)
            res.n_collectives = len(colls)
            res.collective_wire_bytes = sum(c["wire_bytes"] for c in colls)
            res.ok = True
        except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
            res.error = f"{type(e).__name__}: {e}"[:2000]
            res.compile_s = time.time() - t0
        finally:
            set_active_mesh(None)
            set_rule_overrides(None)

    if save:
        os.makedirs(ARTIFACT_DIR, exist_ok=True)
        suffix = "" if variant == "baseline" else f"__{variant}"
        path = os.path.join(
            ARTIFACT_DIR,
            f"{arch_id}__{shape_name}__{mesh_name}{suffix}.json")
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(res), f, indent=1)
    return res


def all_cells() -> List[Tuple[str, str]]:
    out = []
    for arch_id, cfg in ARCHS.items():
        for shape in applicable_shapes(cfg):
            out.append((arch_id, shape))
    return out


def cell_line(r: CellResult) -> str:
    status = "OK " if r.ok else "FAIL"
    return (f"[{status}] {r.arch:24s} {r.shape:12s} {r.mesh:10s} "
            f"trace={r.compile_s:6.1f}s "
            f"peak/dev={r.peak_bytes_per_device / 2**30:6.2f}GiB "
            f"flops/dev={r.flops_per_device:.3e} "
            f"wire={r.collective_wire_bytes / 2**20:9.1f}MiB "
            f"{('ERR: ' + (r.error or ''))[:140] if not r.ok else ''}")


def _run_job(job: Tuple[str, str, str, str, str]) -> CellResult:
    arch_id, shape, mesh, variant, device_type = job
    return run_cell(arch_id, shape, mesh=mesh, variant=variant,
                    device_type=device_type)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    p.add_argument("--device-type", default="cuda", choices=("cuda", "cpu"),
                   help="device type of the mesh (the shards are meta "
                        "tensors either way)")
    p.add_argument("--cells", default=None,
                   help="comma-separated arch:shape:mesh cells, mesh one of "
                        + ", ".join(MESHES))
    p.add_argument("--jobs", type=int, default=1,
                   help="cells traced at once, in as many worker processes "
                        "(each starts its own fake process group per cell)")
    args = p.parse_args(argv)
    if args.device_type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun: no CUDA device (pass --device-type cpu)")

    if args.cells:
        jobs = [tuple(c.split(":")) for c in args.cells.split(",")]
    else:
        if args.all:
            cells = all_cells()
        else:
            assert args.arch and args.shape, "--arch/--shape or --all"
            cells = [(args.arch, args.shape)]
        meshes = ["pod16x16", "pod2x16x16"] if (args.both_meshes
                                                 or args.all) \
            else ["pod2x16x16" if args.multi_pod else "pod16x16"]
        jobs = [(a, s, m) for a, s in cells for m in meshes]
    jobs = [j + (args.variant, args.device_type) for j in jobs]

    if args.jobs > 1:
        import concurrent.futures
        import multiprocessing
        pool = concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn"))
        results = pool.map(_run_job, jobs)
    else:
        results = map(_run_job, jobs)
    n_ok = 0
    for r in results:
        print(cell_line(r), flush=True)
        n_ok += int(r.ok)
    print(f"\n{n_ok}/{len(jobs)} cells traced")
    if n_ok < len(jobs):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
