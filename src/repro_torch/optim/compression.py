"""Gradient compression: int8 with error feedback (mirrors
`repro/optim/compression.py`).

  * `compress_decompress` — the numerics of an int8 gradient reduction on
    one device: quantize (row-wise over the last axis, symmetric, round
    half to even) and dequantize, with a persistent float32 error-feedback
    buffer so the compression bias does not accumulate. 0-d leaves pass
    through unchanged.
  * `compressed_psum` — the int8-compressed sum over a `torch.distributed`
    group: each rank contributes its dequantized int8 rows; the
    contributions are gathered and added in rank order, never with
    `all_reduce`, so every rank gets the same bits.

The row scales floor at 1e-12 (`core/quantization.quantize_rowwise`,
the embedding-table format, floors at 1e-8).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.utils import tree_map

INT8_MAX = 127.0


def _rowwise_q(x: torch.Tensor):
    """float32 `x` (..., d) -> (int8 values, (..., 1) float32 scales)."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp(min=1e-12) / INT8_MAX
    q = torch.round(x / scale).clamp(-INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over `group`'s ranks of each rank's int8-compressed `x`
    (float32 out). The wire carries the dequantized contributions here;
    they are added in rank order, left to right."""
    q, scale = _rowwise_q(x.float())
    mine = q.float() * scale
    parts = [torch.empty_like(mine)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def compress_decompress(grads: Any, error_buf: Any):
    """Error-feedback int8 round trip of a gradient tree: g_hat = Q(g + e),
    e' = g + e - g_hat. Returns (g_hat in each gradient's dtype, e'), both
    new trees."""

    def one(g, e):
        gf = g.float() + e
        if gf.dim() == 0:
            return g, e  # scalars pass through
        q, scale = _rowwise_q(gf)
        g_hat = q.float() * scale
        return g_hat.to(g.dtype), gf - g_hat

    out = tree_map(one, grads, error_buf)
    return (tree_map(lambda _, o: o[0], grads, out),
            tree_map(lambda _, o: o[1], grads, out))


def init_error_buffer(grads_template: Any):
    """Float32 zeros beside each leaf of `grads_template`, on its device."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_template)
