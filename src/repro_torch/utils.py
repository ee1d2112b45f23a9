"""Shape helpers and device resolution shared by the port."""
from __future__ import annotations

import numpy as np
import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks.

    No silent CPU fallback: asking for CUDA (explicitly, or by passing
    None) on a host without a GPU raises. A CUDA device also pins the
    float32 matmul precision to full float32 — TF32 off for both
    `torch.backends.cuda.matmul` and cuDNN — because the MLPs and the LSH
    projection are held against the float32 JAX reference.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA was asked for (the default) but no GPU "
                "is available; pass device='cpu' to run the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"repro_torch: unsupported device {device}")
    return device


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
