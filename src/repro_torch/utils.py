"""Shape helpers, device resolution and the device mesh shared by the port."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def resolve_device(device=None, *, allow_meta: bool = False
                   ) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks.

    No silent CPU fallback: asking for CUDA (explicitly, or by passing
    None) on a host without a GPU raises. A CUDA device also pins the
    float32 matmul precision to full float32 — TF32 off for both
    `torch.backends.cuda.matmul` and cuDNN — because the MLPs and the LSH
    projection are held against the float32 JAX reference.

    `allow_meta` also accepts `meta`, for the shape-only trees of the
    step builders (`launch/steps.py`): no storage, nothing computed.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA was asked for (the default) but no GPU "
                "is available; pass device='cpu' to run the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu" and not (allow_meta and device.type == "meta"):
        raise ValueError(f"repro_torch: unsupported device {device}")
    return device


def make_mesh(shape, names, device=None):
    """The port's `jax.make_mesh`: a `DeviceMesh` of `shape` with axes
    `names` over the default process group, on `cuda` (NCCL) unless the
    caller asks for `cpu` (gloo).

    The caller owns the rendezvous: `torch.distributed.init_process_group`
    with an address, world size, rank and timeout of its own, on a backend
    of the mesh's device. Without one this raises (`init_device_mesh` would
    otherwise start one from environment variables).
    """
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; call "
            "torch.distributed.init_process_group first")
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(names))


def mesh_axis_size(mesh, axis: str) -> int:
    """The number of ranks along `mesh`'s axis `axis`."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def all_gather_axis(x: torch.Tensor, mesh, axis: str) -> list:
    """`x` from every rank along `mesh`'s axis `axis`, in the axis' rank
    order (`dist.all_gather` over the axis' group).

    The tensor stays where it is: a mesh of another device type than the
    tensor's raises, so no gather runs on the host behind the card's back.
    Bool tensors travel as uint8.
    """
    if x.device.type != mesh.device_type:
        raise ValueError(f"all_gather_axis: a {x.device.type} tensor on a "
                         f"{mesh.device_type} mesh")
    y = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(y) for _ in range(mesh_axis_size(mesh, axis))]
    dist.all_gather(parts, y, group=mesh.get_group(axis))
    return [p.to(torch.bool) for p in parts] if x.dtype == torch.bool \
        else parts


def bank_slice(x: torch.Tensor, n_banks: int, bank: int, fill=0):
    """Bank `bank` of `x`'s rows split over `n_banks` banks: the rows are
    padded with `fill` to a multiple of `n_banks`, and the bank's
    `cdiv(n, n_banks)` rows come back as a tensor of their own (a copy, so
    the whole table need not stay alive)."""
    per = cdiv(x.shape[0], n_banks)
    lo, hi = bank * per, (bank + 1) * per
    part = x[lo:min(hi, x.shape[0])]
    pad = per - part.shape[0]
    if pad:
        tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([part, tail])
    return part.clone()


def to_device(tree, device):
    """Numpy arrays and tensors of a nested dict/list, as tensors on
    `device`. Arrays are copied; uint32 arrays (packed signatures) become
    int32 tensors holding the same bits, and bfloat16 arrays (numpy's
    `ml_dtypes.bfloat16`, which `torch.from_numpy` refuses) bfloat16
    tensors holding the same bits."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    if not isinstance(tree, torch.Tensor):
        a = np.array(tree)
        if a.dtype == np.uint32:
            tree = torch.from_numpy(a.view(np.int32))
        elif a.dtype.name == "bfloat16":
            tree = torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16)
        else:
            tree = torch.from_numpy(a)
    return tree.to(device)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, lists and tuples in the order of
    `jax.tree_util.tree_leaves`: dict keys sorted, sequences in order;
    None is an empty subtree."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` and the matching subtrees of `rest`,
    which follow `tree`'s structure down to its leaves and may hold any
    object there (`flatten_up_to`: an optimizer state's `QuantState`
    beside a parameter). Dicts come back with sorted keys, as JAX's do."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = (tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree))
        if hasattr(tree, "_fields"):  # a named tuple (a KVCacheView)
            return type(tree)(*items)
        return type(tree)(items)
    return None if tree is None else fn(tree, *rest)
