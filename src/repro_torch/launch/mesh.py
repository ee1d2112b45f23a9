"""Mesh construction (the port of `repro/launch/mesh.py`).

Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the `pod` axis carries pure data parallelism. The
test meshes are (2, 4) and (2, 2, 2); `make_mesh_of` builds any shape,
such as (1, 1) on one card.

Each builds on `utils.make_mesh` over the default process group, which
the caller starts (`torch.distributed.init_process_group` with its own
address, world size, rank and timeout): nothing here starts a
rendezvous, and a group whose world size is not the mesh's size raises.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.utils import make_mesh

SINGLE_POD_AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


def make_mesh_of(shape: tuple, device=None):
    """A ("data", "model") mesh of a 2-tuple `shape`, or a ("pod", "data",
    "model") one of a 3-tuple, on `cuda` (NCCL) unless `device` says
    `cpu` (gloo)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"mesh shape {shape}: (data, model) or "
                         f"(pod, data, model)")
    axes = SINGLE_POD_AXES if len(shape) == 2 else MULTI_POD_AXES
    size = 1
    for s in shape:
        size *= s
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape}: no process group; call "
            f"torch.distributed.init_process_group first")
    if dist.get_world_size() != size:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {size} "
                         f"ranks, the process group has "
                         f"{dist.get_world_size()}")
    return make_mesh(shape, axes, device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    return make_mesh_of((2, 16, 16) if multi_pod else (16, 16), device)


def make_test_mesh(*, multi_pod: bool = False, device=None):
    """Small mesh for sharding tests (8 ranks)."""
    return make_mesh_of((2, 2, 2) if multi_pod else (2, 4), device)


def data_axes_of(mesh) -> tuple:
    return ("pod", "data") if "pod" in _axis_names(mesh) else ("data",)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh` or of any object with the
    reference's `shape` mapping and `axis_names`."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _axis_names(mesh) -> tuple:
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)
