"""Cache trees per model family, in the reference's structures.

The port of `repro/serving/kv_cache.py`. int8 KV caches follow the iMARS
ET format: int8 values and one f32 scale per (position, head) over
head_dim. The trees:
- dense (also the audio and VLM models), and MoE with every layer MoE:
  one KVCacheView stacked over the layers;
- MoE with alternating dense / MoE layers (llama4): ``{"dense": view,
  "moe": view}``, each stacked over half the layers;
- SSM: ``(conv, ssm)`` float32 states stacked over the layers;
- hybrid: ``(attn, (conv, ssm), rem_state)``: the shared block's cache
  of each group stacked over the groups, the Mamba2 states over (groups,
  attn_every), and rem_state = (the remainder invocation's cache, with no
  layer axis, and its layers' (conv, ssm)), or None without a remainder.

Decode writes a KV cache in place (see `models/attention.py`) and returns
the tree with new recurrent states: the states the caller passed in keep
their values.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import KVCacheView
from repro_torch.utils import resolve_device, tree_leaves


def _kv_view(cfg: ModelConfig, lead: tuple, batch: int, cache_len: int,
             dtype: str, device) -> KVCacheView:
    R, hd = cfg.rep_kv_heads, cfg.head_dim
    shape = lead + (batch, R, cache_len, hd)
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


def _ssm_states(cfg: ModelConfig, lead: tuple, batch: int, device):
    return (torch.zeros(lead + (batch, cfg.ssm_conv - 1,
                                ssm_mod.conv_dim(cfg)), device=device),
            torch.zeros(lead + (batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state), device=device))


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: str = "bfloat16", device=None):
    """Empty cache tree matching `models.transformer.forward(mode=
    "decode")`, on `device` (default `cuda`; `meta` for shapes alone)."""
    device = resolve_device(device, allow_meta=True)
    L = cfg.n_layers
    if cfg.family in ("dense", "vlm", "audio") or (
            cfg.family == "moe" and cfg.moe_layer_step == 1):
        return _kv_view(cfg, (L,), batch, cache_len, dtype, device)
    if cfg.family == "moe":
        return {k: _kv_view(cfg, (L // 2,), batch, cache_len, dtype, device)
                for k in ("dense", "moe")}
    if cfg.family == "ssm":
        return _ssm_states(cfg, (L,), batch, device)
    if cfg.family == "hybrid":
        groups, rem = divmod(L, cfg.attn_every)
        rem_state = None
        if rem:
            rem_state = (_kv_view(cfg, (), batch, cache_len, dtype, device),
                         _ssm_states(cfg, (rem,), batch, device))
        return (_kv_view(cfg, (groups,), batch, cache_len, dtype, device),
                _ssm_states(cfg, (groups, cfg.attn_every), batch, device),
                rem_state)
    raise ValueError(f"no cache tree for family {cfg.family!r}")


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(cache))
