"""Row-wise symmetric int8 quantization — the embedding-table format.

Mirrors `repro/core/quantization.py`. `torch.round` rounds half to even,
as `jnp.round` does, so quantized tables match the reference bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

INT8_MAX = 127.0


@dataclass(frozen=True)
class QuantizedTensor:
    """Row-wise symmetric int8: `values[i, :] * scales[i]` ~ original."""

    values: torch.Tensor  # (n, d) int8
    scales: torch.Tensor  # (n, 1) float32

    @property
    def shape(self):
        return self.values.shape


def quantize_rowwise(x: torch.Tensor) -> QuantizedTensor:
    """Symmetric per-row int8 quantization of float32 `x` (..., d)."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp(min=1e-8) / INT8_MAX
    q = torch.round(x / scale).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    return QuantizedTensor(values=q, scales=scale.to(torch.float32))


def dequantize_rowwise(q: QuantizedTensor) -> torch.Tensor:
    return q.values.to(torch.float32) * q.scales
