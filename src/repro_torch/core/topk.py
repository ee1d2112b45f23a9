"""CTR-buffer threshold top-k (mirrors `repro/core/topk.py`).

`jax.lax.top_k` gives ties to the lower index and `torch.topk` does not
promise that, so the selection is a stable descending sort.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TopKResult(NamedTuple):
    scores: torch.Tensor  # (..., k) f32, -inf padded
    indices: torch.Tensor  # (..., k) int32, -1 padded
    counts: torch.Tensor  # (...,) int32 — matches above threshold


def threshold_topk(scores: torch.Tensor, threshold: float,
                   k: int) -> TopKResult:
    mask = scores >= threshold
    counts = mask.sum(-1, dtype=torch.int32)
    masked = torch.where(mask, scores, float("-inf"))
    kk = min(k, scores.shape[-1])
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :kk], idx[..., :kk].to(torch.int32)
    idx = torch.where(torch.isfinite(vals), idx, -1)
    if kk < k:
        pad = k - kk
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("-inf"))
    return TopKResult(scores=vals, indices=idx, counts=counts)
