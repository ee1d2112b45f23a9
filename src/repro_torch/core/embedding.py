"""Quantized embedding lookups and bags (mirrors `repro/core/embedding.py`).

`embedding_bag` pools through the fused int8 kernel op
(`kernels/ops.py:embedding_pool`).
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.core.quantization import (
    QuantizedTensor,
    dequantize_rowwise,
    quantize_rowwise,
)
from repro_torch.kernels import ops
from repro_torch.utils import resolve_device


def init_table(generator: torch.Generator, n_rows: int, dim: int,
               scale: float = 0.05, device=None) -> QuantizedTensor:
    """A random int8 table on `device` (default `cuda`): `scale` * N(0, 1)
    drawn from `generator` (on its own device), quantized row-wise."""
    device = resolve_device(device)
    dense = torch.randn((n_rows, dim), generator=generator,
                        device=generator.device, dtype=torch.float32)
    return quantize_rowwise((scale * dense).to(device))


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


def multi_table_pool(
    tables: Mapping[str, QuantizedTensor],
    features: Mapping[str, torch.Tensor],  # name -> (B, L) ids
    mode: str = "sum",
    combine: str = "concat",  # "concat" | "sum"
) -> torch.Tensor:
    """Pool every feature through its table, by sorted name; combine
    "concat" (YoutubeDNN's feature concatenation) or "sum" (DLRM's ADD
    pooling; equal widths), the sum left to right."""
    outs = [embedding_bag(tables[name], features[name], mode=mode)
            for name in sorted(features)]
    if combine == "sum":
        total = outs[0]
        for o in outs[1:]:
            total = total + o
        return total
    if combine != "concat":
        raise ValueError(f"multi_table_pool: combine {combine!r} "
                         f"(concat or sum)")
    return torch.cat(outs, dim=-1)


def table_from_dense(dense: torch.Tensor) -> QuantizedTensor:
    return quantize_rowwise(dense)


def table_to_dense(table: QuantizedTensor) -> torch.Tensor:
    return dequantize_rowwise(table)
