"""KV caches of the dense LM family: stacked per-layer views.

The port of `repro/serving/kv_cache.py`. int8 caches follow the iMARS ET
format: int8 values and one f32 scale per (position, head) over head_dim.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import KVCacheView
from repro_torch.utils import resolve_device


def _kv_view(cfg: ModelConfig, n_layers: int, batch: int, cache_len: int,
             dtype: str, device) -> KVCacheView:
    R, hd = cfg.rep_kv_heads, cfg.head_dim
    shape = (n_layers, batch, R, cache_len, hd)
    if dtype == "int8":
        return KVCacheView(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1] + (1,), device=device),
            v_scale=torch.zeros(shape[:-1] + (1,), device=device))
    dt = getattr(torch, dtype)
    return KVCacheView(k=torch.zeros(shape, dtype=dt, device=device),
                       v=torch.zeros(shape, dtype=dt, device=device),
                       k_scale=None, v_scale=None)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: str = "bfloat16", device=None) -> KVCacheView:
    """Empty cache matching `models.transformer.forward(mode="decode")`,
    on `device` (default `cuda`)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"caches of family {cfg.family!r} are not ported yet "
            f"(ROADMAP.md, queue A.5)")
    return _kv_view(cfg, cfg.n_layers, batch, cache_len, dtype,
                    resolve_device(device))


def cache_bytes(cache: KVCacheView) -> int:
    return sum(t.numel() * t.element_size() for t in cache if t is not None)
