"""Production meshes: the port of `repro.launch.mesh`, over
`torch.distributed.device_mesh`.

Mesh topology:
    single-pod : (data=16, model=16)                   = 256 devices
    multi-pod  : (pod=2, data=16, model=16)            = 512 devices

The `pod` axis carries only gradient reduction; `model` stays inside a
host's NVLink domain.  Defined as functions (never module-level
constants) so importing this module never touches a process group or a
device: the dry-run (`repro_torch.launch.dryrun`) starts a fake process
group of 256 or 512 ranks first.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def make_mesh_compat(shape: Tuple[int, ...], axes: Tuple[str, ...],
                     devices: Optional[Sequence[int]] = None, *,
                     device_type: str = "cuda"):
    """A `DeviceMesh` of `shape` named `axes` over the default process
    group: `init_device_mesh`, or with `devices` (global ranks, row-major)
    a mesh over exactly those ranks."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    if devices is None:
        return init_device_mesh(device_type, tuple(shape),
                                mesh_dim_names=tuple(axes))
    ranks = torch.tensor(list(devices), dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world_size()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {have} — run via "
            "repro_torch.launch.dryrun (a fake process group of "
            f"{n} ranks)")
    return make_mesh_compat(shape, axes, devices=range(n),
                            device_type=device_type)


def make_local_mesh(*, device_type: str = "cuda"):
    """Whatever the process group holds, factored into (data, model)
    (one card: (1, 1))."""
    n = _world_size()
    if n == 0:
        raise RuntimeError("make_local_mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    model = 1
    for m in (16, 8, 4, 2, 1):
        if n % m == 0:
            model = m
            break
    return make_mesh_compat((n // model, model), ("data", "model"),
                            device_type=device_type)


def mesh_chips(mesh) -> int:
    from ..parallel.sharding import mesh_axes
    return math.prod(mesh_axes(mesh).values())
