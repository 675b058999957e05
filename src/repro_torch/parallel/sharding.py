"""Sharding rules: logical axes -> mesh axes (DP / FSDP / TP / EP / SP).
The port of `repro.parallel.sharding`, in `torch.distributed`'s idiom.

Mesh: ``(pod, data, model)`` multi-pod or ``(data, model)`` single-pod.
  * ``pod``+``data`` -- batch/data parallel domain; FSDP (zero-style)
    weight sharding lives on ``data``; the pod axis carries only gradient
    reduction.
  * ``model`` -- tensor parallel (fused head / ffn dims), expert parallel
    (experts), and *sequence parallel* for attention scores (queries'
    S-dim shards over ``model``).

How the reference's JAX types map here:
  * a mesh is a `torch.distributed.device_mesh.DeviceMesh` with
    ``mesh_dim_names``, or any object whose ``shape`` is a dict of axis
    sizes (the rule tests' duck-typed mesh);
  * `PartitionSpec` is a tuple with one entry per tensor dim: None, an axis
    name, or a tuple of names;
  * `NamedSharding` holds the mesh, the spec and one DTensor placement per
    mesh dim: ``Shard(d)`` where the spec puts that axis on tensor dim
    ``d``, else ``Replicate()``.  A dim over ``("pod", "data")`` is
    ``Shard(d)`` on both mesh dims, which DTensor splits in mesh-dim order
    -- the row-major order of the named axes, as JAX splits it;
  * `constrain` is ``DTensor.redistribute`` to the rule's placements.

`constrain` is divisibility-aware: an axis is applied only when it divides
the dimension, so reduced smoke configs and B=1 long-context cells run
without special-casing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import torch

# logical axis name -> mesh axes (None = replicate)
LOGICAL_RULES: Dict[str, Any] = {
    "vocab": "model",
    "heads": "model",
    "kv": "model",
    "ffn": "model",
    "experts": "model",
    "experts_dp": "data",   # EP-over-data profile
    "inner": "model",       # mamba d_inner
    "lru_heads": "model",   # rg-lru block-diagonal gate blocks
    "embed": "data",        # FSDP/zero dimension
    "batch": ("pod", "data"),
    "seq_model": "model",   # sequence-parallel attention
    "cache_t": "model",     # decode: KV-cache time dim over model
}

_ACTIVE_MESH: Optional[Any] = None
_RULE_OVERRIDES: Dict[str, Any] = {}


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name, or a tuple of
    names (a dim split over several axes, the first outermost).  A tuple
    of one name is that name, as JAX normalizes it."""

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def set_active_mesh(mesh: Optional[Any]) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_active_mesh() -> Optional[Any]:
    return _ACTIVE_MESH


def set_rule_overrides(overrides: Optional[Dict[str, Any]]) -> None:
    """Per-run logical-rule overrides, e.g. {"embed": None} to keep
    weights resident (replicated over data) for decode serving."""
    global _RULE_OVERRIDES
    _RULE_OVERRIDES = dict(overrides or {})


def mesh_axes(mesh: Any) -> Dict[str, int]:
    """Axis name -> size, in mesh-dim order."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _mesh_axis_size(mesh: Any, axis: Any) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(_mesh_axis_size(mesh, a) for a in axis)
    return int(mesh_axes(mesh).get(axis, 1))


def _resolve_axis(mesh: Any, logical: Optional[str], dim: int):
    """Mesh axes for one logical dim, dropped unless it divides `dim`."""
    if logical is None:
        return None
    if logical in _RULE_OVERRIDES:
        rule = _RULE_OVERRIDES[logical]
    else:
        rule = LOGICAL_RULES.get(logical)
    if rule is None:
        return None
    if isinstance(rule, (tuple, list)):
        # use the longest prefix of axes whose product divides dim
        chosen = []
        size = 1
        for a in rule:
            a_sz = _mesh_axis_size(mesh, a)
            if a_sz > 1 and dim % (size * a_sz) == 0:
                chosen.append(a)
                size *= a_sz
        return tuple(chosen) if chosen else None
    if _mesh_axis_size(mesh, rule) <= 1:
        return None
    return rule if dim % _mesh_axis_size(mesh, rule) == 0 else None


def _names(entry: Any) -> tuple:
    """The mesh axes of one spec entry (None, a name, or names)."""
    return entry if isinstance(entry, tuple) else ((entry,) if entry else ())


def spec_for(mesh: Any, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> PartitionSpec:
    axes = [_resolve_axis(mesh, la, d) for la, d in zip(logical_axes, shape)]
    # an axis may appear at most once in a PartitionSpec
    seen = set()
    out = []
    for a in axes:
        names = _names(a)
        if any(n in seen for n in names):
            out.append(None)
        else:
            seen.update(names)
            out.append(a)
    return PartitionSpec(*out)


def placements_for(mesh: Any, spec: Sequence[Any]) -> List[Any]:
    """One DTensor placement per mesh dim for `spec`.  A tensor dim over
    several axes must name them in mesh-dim order: DTensor splits a dim
    sharded on two mesh dims in that order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    on: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        group = _names(entry)
        order = [names.index(a) for a in group]
        if order != sorted(order):
            raise ValueError(f"{spec}: axes {group} of dim {d} are not in "
                             f"the mesh's order {tuple(names)}")
        on.update({a: d for a in group})
    return [Shard(on[n]) if n in on else Replicate() for n in names]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: PartitionSpec
    placements: tuple


def named_sharding(mesh: Any, logical_axes: Sequence[Optional[str]],
                   shape: Sequence[int]) -> NamedSharding:
    spec = spec_for(mesh, logical_axes, shape)
    return NamedSharding(mesh, spec, tuple(placements_for(mesh, spec)))


def is_axes(x: Any) -> bool:
    """A logical-axes leaf: a tuple of axis names and Nones."""
    return isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x)


def tree_shardings(mesh: Any, abstract_tree: Any, axes_tree: Any) -> Any:
    """(tree of shaped leaves, logical-axes tree) -> NamedSharding tree.
    The walk follows ``axes_tree``: a leaf of ``abstract_tree`` is any
    object with a ``shape`` (a tensor, a meta tensor, a `CacheSpec`, a
    numpy array)."""
    if is_axes(axes_tree):
        return named_sharding(mesh, axes_tree, tuple(abstract_tree.shape))
    return {k: tree_shardings(mesh, abstract_tree[k], v)
            for k, v in axes_tree.items()}


def local_shape(shape: Sequence[int], mesh: Any,
                spec: Sequence[Any]) -> tuple:
    """The shape of one device's shard (every axis divides its dim)."""
    return tuple(d // _mesh_axis_size(mesh, a) for d, a in
                 zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


def local_slices(shape: Sequence[int], mesh: Any, spec: Sequence[Any],
                 coordinate: Optional[Sequence[int]] = None) -> tuple:
    """The index (one slice per dim) of the shard that the device at
    `coordinate` (default: this rank's, ``mesh.get_coordinate()``) holds:
    a dim over axes (a, b) splits into size(a) x size(b) blocks, block
    ``i_a * size(b) + i_b`` on the device at (i_a, i_b) -- row-major over
    the named axes, as both JAX and DTensor split it."""
    sizes = mesh_axes(mesh)
    names = list(sizes)
    coord = list(mesh.get_coordinate() if coordinate is None
                 else coordinate)
    out = []
    for d, n in enumerate(shape):
        block, parts = 0, 1
        for a in _names(spec[d] if d < len(spec) else None):
            block = block * sizes[a] + coord[names.index(a)]
            parts *= sizes[a]
        step = n // parts
        out.append(slice(block * step, (block + 1) * step))
    return tuple(out)


def from_local(local: torch.Tensor, mesh: Any, placements: Sequence[Any],
               shape: Sequence[int]) -> Any:
    """A DTensor of global `shape` (contiguous) from this rank's shard."""
    from torch.distributed.tensor import DTensor
    stride, step = [], 1
    for n in reversed(tuple(shape)):
        stride.insert(0, step)
        step *= max(n, 1)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def distribute(t: torch.Tensor, sh: NamedSharding) -> Any:
    """`t` (the whole tensor, on any device) as a DTensor with `sh`'s
    placements: this rank's slice (`local_slices`), moved to the mesh's
    device type.  No collective runs."""
    local = t[local_slices(t.shape, sh.mesh, sh.spec)]
    return from_local(local.to(sh.mesh.device_type).contiguous(), sh.mesh,
                      sh.placements, t.shape)


def is_dtensor(x: Any) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_offset(x: Any, dim: int) -> int:
    """Where this rank's shard of DTensor `x` starts along `dim`."""
    from torch.distributed.tensor import Shard
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    block = 0
    for i, p in enumerate(x.placements):
        if p == Shard(dim):
            block = block * mesh.size(i) + coord[i]
    return block * x.to_local().shape[dim]


def _boundary(old: Sequence[int], new: Sequence[int], d: int):
    """The dim of `new` that is dim `d` of `old` (same size and the same
    product of the dims before it), or None."""
    before = math.prod(old[:d])
    for j, n in enumerate(new):
        if math.prod(new[:j]) == before and n == old[d]:
            return j
    return None


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(shape)``.  A DTensor is reshaped shard by shard, so
    DTensor's view rules (which differ across torch releases, and refuse
    to split or merge a sharded dim) never run: a shard of dim 0 is a
    contiguous block of the flat tensor and stays one of the new dim 0
    when that divides; a shard of another dim stays where the reshape
    keeps that dim whole.  Any other shard is gathered first."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    from torch.distributed.tensor import Replicate, Shard
    old = tuple(x.shape)
    if -1 in shape:
        i = shape.index(-1)
        rest = math.prod(shape[:i] + shape[i + 1:])
        shape = shape[:i] + (math.prod(old) // rest,) + shape[i + 1:]
    mesh, places = x.device_mesh, list(x.placements)
    split0 = math.prod(mesh.size(i) for i, p in enumerate(places)
                       if p == Shard(0))
    target = {}
    for i, p in enumerate(places):
        if not isinstance(p, Shard):
            continue
        j = 0 if p.dim == 0 and shape and shape[0] % split0 == 0 \
            else None if p.dim == 0 else _boundary(old, shape, p.dim)
        if j is None:
            places[i] = Replicate()
        else:
            target[i] = j
    if places != list(x.placements):
        x = x.redistribute(mesh, places)
    local_shape = list(shape)
    for i, j in target.items():
        local_shape[j] //= mesh.size(i)
    out = [Shard(target[i]) if i in target else p
           for i, p in enumerate(places)]
    return from_local(x.to_local().reshape(local_shape), mesh, out, shape)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *ops)``.  With DTensor operands it runs shard by
    shard, so DTensor's rules for the views inside an einsum (which differ
    across torch releases) never run.  On each mesh dim one subscript may
    stay sharded: the one already sharded on the most operand bytes.
    Every operand that holds it is split on it (a local slice where it
    was replicated), every other operand is gathered on that mesh dim;
    the result is sharded on it, or a partial sum where it is summed
    over.  Plain tensors among DTensors count as replicated."""
    if not any(is_dtensor(o) for o in ops):
        return torch.einsum(eq, *ops)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ins, out = eq.replace(" ", "").split("->")
    subs = ins.split(",")
    mesh = next(o for o in ops if is_dtensor(o)).device_mesh
    ops = [o if is_dtensor(o) else DTensor.from_local(
        o, mesh, [Replicate()] * mesh.ndim, run_check=False) for o in ops]
    nbytes = [o.numel() * o.element_size() for o in ops]
    places = [list(o.placements) for o in ops]
    out_places = []
    for i in range(mesh.ndim):
        held = {}
        for k, (o, sub) in enumerate(zip(ops, subs)):
            p = o.placements[i]
            if isinstance(p, Shard):
                held[sub[p.dim]] = held.get(sub[p.dim], 0) + nbytes[k]
        keep = max(held, key=held.get) if held else None
        for k, sub in enumerate(subs):
            places[k][i] = Shard(sub.index(keep)) \
                if keep is not None and keep in sub else Replicate()
        out_places.append(Replicate() if keep is None else
                          Shard(out.index(keep)) if keep in out
                          else Partial())
    ops = [o.redistribute(mesh, pl) for o, pl in zip(ops, places)]
    sizes = {c: n for o, sub in zip(ops, subs) for c, n in zip(sub, o.shape)}
    shape = tuple(sizes[c] for c in out)
    local = torch.einsum(eq, *[o.to_local() for o in ops])
    return from_local(local, mesh, out_places, shape)


def constrain(x: torch.Tensor,
              logical_axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Redistribute a DTensor to its logical axes' placements; `x` itself
    without an active mesh or for a plain tensor."""
    mesh = _ACTIVE_MESH
    if mesh is None or not is_dtensor(x):
        return x
    spec = spec_for(mesh, logical_axes, x.shape)
    return x.redistribute(mesh, placements_for(mesh, spec))


def batch_spec(mesh: Any, shape: Sequence[int],
               batch_logical: str = "batch") -> PartitionSpec:
    """Spec for a (batch, ...) input tensor."""
    axes = [batch_logical] + [None] * (len(shape) - 1)
    return spec_for(mesh, axes, shape)
