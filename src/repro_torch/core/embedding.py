"""Quantized embedding lookups and bags (mirrors `repro/core/embedding.py`).

`embedding_bag` pools through the fused int8 kernel op
(`kernels/ops.py:embedding_pool`).
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import QuantizedTensor
from repro_torch.kernels import ops


def lookup(table: QuantizedTensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain row lookup: ids (...,) -> (..., d) f32. -1 ids give zeros."""
    safe = ids.clamp(0, table.values.shape[0] - 1).long()  # as jnp clamps
    rows = table.values[safe].to(torch.float32) * table.scales[safe]
    return torch.where((ids >= 0)[..., None], rows, 0.0)


def embedding_bag(
    table: QuantizedTensor,
    ids: torch.Tensor,  # (B, L) int32, -1 padded
    weights: torch.Tensor | None = None,
    mode: str = "sum",
) -> torch.Tensor:
    """Pooled lookup -> (B, d). mode in {sum, mean}."""
    pooled = ops.embedding_pool(table.values, table.scales, ids, weights)
    if mode == "mean":
        count = (ids >= 0).to(torch.float32).sum(-1, keepdim=True)
        pooled = pooled / count.clamp(min=1.0)
    return pooled
