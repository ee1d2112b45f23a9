"""Config-driven decoder LM, dense family: qwen3-8b (qk-norm), qwen2.5-3b
(qkv bias, tied embeddings), chatglm3-6b (partial rotary).

The port of `repro/models/transformer.py` for inference. Layer params are
stacked on a leading `n_layers` axis as in the reference; its
`jax.lax.scan` over layers is a Python loop that indexes the stacked
tensors. The MoE, SSM, hybrid, audio and VLM families raise
`NotImplementedError` (ROADMAP.md, queue A.5).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import KVCacheView, attention, init_attention
from repro_torch.models.layers import (
    init_mlp,
    init_rms_norm,
    mlp,
    normal,
    param_dtype,
    rms_norm,
)
from repro_torch.utils import resolve_device


class ModelOutput(NamedTuple):
    hidden: torch.Tensor | None  # (B, S, D) final hidden
    logits: torch.Tensor | None  # (B, S_out, V)
    aux_loss: torch.Tensor
    caches: Any  # stacked per-layer KVCacheView (serve modes)


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the port "
            f"serves the dense family (ROADMAP.md, queue A.5)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights in the reference's layout and scales, drawn from
    `generator`, which must live on `device` (default `cuda`)."""
    _dense_only(cfg)
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, params on "
                         f"{device}")
    dt = param_dtype(cfg)
    V, D, L = cfg.padded_vocab, cfg.d_model, (cfg.n_layers,)
    params = {
        "embed": normal(generator, (V, D), 0.02, dt, device),
        "layers": {
            "norm1": init_rms_norm(D, dt, device, L),
            "norm2": init_rms_norm(D, dt, device, L),
            "attn": init_attention(generator, cfg, device, L),
            "mlp": init_mlp(generator, cfg, device, lead=L),
        },
        "final_norm": init_rms_norm(D, dt, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(generator, (D, V), D**-0.5, dt, device)
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _attn_mlp_block(p, x, cfg, positions, *, cache=None, cache_index=None,
                    make_cache=False, cache_len=None, cache_dtype="bfloat16",
                    attn_impl="blocked"):
    h, new_cache = attention(
        p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, positions,
        cache=cache, cache_index=cache_index, make_cache=make_cache,
        cache_len=cache_len, cache_dtype=cache_dtype, attn_impl=attn_impl)
    x = x + h
    x = x + mlp(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg)
    return x, new_cache


def _index(tree, i: int):
    """Layer `i` of a stacked params dict or KVCacheView (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, KVCacheView):
        return KVCacheView(*(None if t is None else t[i] for t in tree))
    return tree[i]


def _stack(views: list) -> KVCacheView:
    return KVCacheView(*(None if ts[0] is None else torch.stack(ts)
                         for ts in zip(*views)))


# ---------------------------------------------------------------------------
# embedding in / out
# ---------------------------------------------------------------------------
def embed_tokens(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    _dense_only(cfg)
    return params["embed"][batch["tokens"].long()]  # (B, S, D)


def unembed(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h (B, S, D) -> logits (B, S, padded_V); the vocab-padding tail
    (ids >= vocab_size) is -1e30 so argmax never emits a padded id."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = h @ w
    if cfg.padded_vocab != cfg.vocab_size:
        ids = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = logits.masked_fill(ids >= cfg.vocab_size, -1e30)
    return logits


def default_positions(cfg: ModelConfig, batch: dict, B: int, S: int,
                      offset=0) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    dev = batch["tokens"].device
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None, :] + int(
        offset)
    return pos.expand(B, S)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
@torch.no_grad()
def forward(
    params: dict,
    cfg: ModelConfig,
    batch: dict,
    *,
    mode: str = "train",  # train | prefill | decode
    caches: Any = None,  # stacked per-layer KVCacheView (decode)
    cache_index=None,
    cache_len: int | None = None,
    cache_dtype: str = "bfloat16",
    remat: str = "none",  # training only; accepted for the signature
    attn_impl: str = "blocked",
    logits_mode: str = "auto",  # auto | none | last | all
) -> ModelOutput:
    """The reference's `forward` for the dense family. Decode updates
    `caches` in place and returns them; `batch` values may be numpy arrays
    or tensors and move to the params' device."""
    _dense_only(cfg)
    dev = params["embed"].device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    B, S = batch["tokens"].shape
    x = embed_tokens(params, cfg, batch)
    offset = cache_index if mode == "decode" else 0
    positions = default_positions(cfg, batch, B, S, offset=offset)

    x, caches = _transformer_stack(params, cfg, x, positions, mode, caches,
                                   cache_index, cache_len, cache_dtype,
                                   attn_impl)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)

    if logits_mode == "auto":
        logits_mode = {"train": "none", "prefill": "last",
                       "decode": "all"}[mode]
    logits = None
    if logits_mode == "last":
        logits = unembed(params, cfg, x[:, -1:])
    elif logits_mode == "all":
        logits = unembed(params, cfg, x)
    return ModelOutput(hidden=x, logits=logits,
                       aux_loss=torch.zeros((), device=dev), caches=caches)


def _transformer_stack(params, cfg, x, positions, mode, caches, cache_index,
                       cache_len, cache_dtype, attn_impl):
    """The layers in order; prefill stacks the new caches, decode writes
    into `caches` (per-layer views of the stacked tensors) in place."""
    made = []
    for i in range(cfg.n_layers):
        x, new_cache = _attn_mlp_block(
            _index(params["layers"], i), x, cfg, positions,
            cache=_index(caches, i) if mode == "decode" else None,
            cache_index=cache_index, make_cache=(mode == "prefill"),
            cache_len=cache_len, cache_dtype=cache_dtype,
            attn_impl=attn_impl)
        made.append(new_cache)
    if mode == "prefill":
        return x, _stack(made)
    return x, (caches if mode == "decode" else None)
