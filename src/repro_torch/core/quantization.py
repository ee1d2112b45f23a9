"""Symmetric int8 quantization (mirrors `repro/core/quantization.py`).

  * row-wise (one scale per row over the last axis) — the embedding-table
    format; each quantized row is the software image of one CMA row;
  * block-wise over the flattened tensor, and along any one axis
    (`quantize_symmetric_int8`) — the same idea beyond the paper.

`torch.round` rounds half to even, as `jnp.round` does, so quantized
tables match the reference bit for bit. Row-wise and axis scales floor at
1e-8, block scales at 1e-12, as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.utils import cdiv

INT8_MAX = 127.0


@dataclass(frozen=True)
class QuantizedTensor:
    """Row-wise symmetric int8: `values[i, :] * scales[i]` ~ original."""

    values: torch.Tensor  # (n, d) int8
    scales: torch.Tensor  # (n, 1) float32

    @property
    def shape(self):
        return self.values.shape


@dataclass(frozen=True)
class BlockQuantizedTensor:
    """Block-wise symmetric int8 over the flattened tensor, zero-padded to
    a whole number of blocks."""

    values: torch.Tensor  # (n_blocks, block) int8
    scales: torch.Tensor  # (n_blocks, 1) float32
    orig_shape: tuple = ()
    block: int = 256

    @property
    def shape(self):
        return self.orig_shape


def quantize_rowwise(x: torch.Tensor) -> QuantizedTensor:
    """Symmetric per-row int8 quantization of float32 `x` (..., d)."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp(min=1e-8) / INT8_MAX
    q = torch.round(x / scale).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    return QuantizedTensor(values=q, scales=scale.to(torch.float32))


def dequantize_rowwise(q: QuantizedTensor) -> torch.Tensor:
    return q.values.to(torch.float32) * q.scales


def quantize_blockwise(x: torch.Tensor, block: int = 256
                       ) -> BlockQuantizedTensor:
    """Symmetric block-wise int8 over the flattened `x`."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    n_blocks = cdiv(max(n, 1), block)
    blocks = F.pad(flat, (0, n_blocks * block - n)).reshape(n_blocks, block)
    absmax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp(min=1e-12) / INT8_MAX
    q = torch.round(blocks / scale).clamp(-INT8_MAX, INT8_MAX)
    return BlockQuantizedTensor(values=q.to(torch.int8),
                                scales=scale.to(torch.float32),
                                orig_shape=tuple(x.shape), block=block)


def dequantize_blockwise(q: BlockQuantizedTensor,
                         dtype=torch.float32) -> torch.Tensor:
    n = math.prod(q.orig_shape) if q.orig_shape else 0
    flat = (q.values.to(torch.float32) * q.scales).reshape(-1)[:n]
    return flat.reshape(q.orig_shape).to(dtype)


def quantize_symmetric_int8(x: torch.Tensor, axis: int = -1):
    """(int8 values, float32 scales broadcastable along `axis`)."""
    absmax = x.abs().amax(dim=axis, keepdim=True)
    scale = absmax.clamp(min=1e-8) / INT8_MAX
    q = torch.round(x / scale).clamp(-INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale.to(torch.float32)


def rowwise_quant_error_bound(q: QuantizedTensor) -> torch.Tensor:
    """The largest absolute error of row-wise quantization: half a scale
    per element."""
    return q.scales / 2.0
