"""GQA attention with qk-norm and RoPE: blocked or flash prefill, cached
decode into a bfloat16 or int8 KV cache.

The port of `repro/models/attention.py` (inference only: the custom VJP of
the blocked attention is training and waits). Heads are grouped as in the
reference: kv heads are repeated `kv_repeat` times to `rep_kv` heads, and
q is viewed as (B, rep_kv, G, S, hd) with G = n_heads / rep_kv.

int8 KV caches hold int8 values with one float32 scale per (position,
head) row over hd — the paper's ET quantization applied to the cache.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import quantize_rowwise
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    apply_rope,
    init_linear,
    init_rms_norm,
    linear,
    param_dtype,
    rms_norm,
    rope_angles,
)


class KVCacheView(NamedTuple):
    """One layer's cache (or all layers', stacked on a leading axis).
    k/v: (B, rep_kv, S_max, hd) in the cache dtype; scales present iff
    int8, shape (B, rep_kv, S_max, 1) f32."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None
    v_scale: torch.Tensor | None


def init_attention(gen, cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    dt = param_dtype(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": init_linear(gen, d, cfg.n_heads * hd, dt, device,
                          bias=cfg.qkv_bias, lead=lead),
        "wk": init_linear(gen, d, cfg.n_kv_heads * hd, dt, device,
                          bias=cfg.qkv_bias, lead=lead),
        "wv": init_linear(gen, d, cfg.n_kv_heads * hd, dt, device,
                          bias=cfg.qkv_bias, lead=lead),
        "wo": init_linear(gen, cfg.n_heads * hd, d, dt, device, lead=lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(hd, dt, device, lead)
        p["k_norm"] = init_rms_norm(hd, dt, device, lead)
    return p


def _project_qkv(p, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = linear(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = linear(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    ang = rope_angles(cfg, positions)
    q = apply_rope(q, ang, cfg.rope_fraction)
    k = apply_rope(k, ang, cfg.rope_fraction)
    if cfg.kv_repeat > 1:
        k = k.repeat_interleave(cfg.kv_repeat, dim=2)
        v = v.repeat_interleave(cfg.kv_repeat, dim=2)
    return q, k, v


def gqa_blocked_attention(q5, k, v, *, causal: bool = True,
                          q_offset: int = 0, block_k: int = 1024):
    """Online-softmax GQA attention over kv blocks of `block_k`, forward.

    q5 (B, rep_kv, G, Sq, hd), k/v (B, rep_kv, Sk, hd) -> (B, rep_kv, G,
    Sq, hd) float32, never materializing more than one block of scores:
    the forward of the reference's `_flash_fwd_impl`, -inf masking and the
    carried max guarded where a row has no valid key yet.
    """
    B, R, G, Sq, hd = q5.shape
    Sk = k.shape[2]
    dev = q5.device
    qf = q5.float() * hd**-0.5
    rows = torch.arange(Sq, device=dev)[:, None] + q_offset
    m = torch.full((B, R, G, Sq), float("-inf"), device=dev)
    l = torch.zeros((B, R, G, Sq), device=dev)
    acc = torch.zeros((B, R, G, Sq, hd), device=dev)
    for lo in range(0, Sk, min(block_k, Sk)):
        kb = k[:, :, lo:lo + block_k].float()
        vb = v[:, :, lo:lo + block_k].float()
        s = torch.einsum("brgqd,brkd->brgqk", qf, kb)
        cols = lo + torch.arange(kb.shape[2], device=dev)[None, :]
        masked = (cols > rows) if causal else torch.zeros_like(
            cols, dtype=torch.bool)
        s.masked_fill_(masked, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp_(s.sub_(m_safe[..., None])).masked_fill_(masked, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("brgqk,brkd->brgqd", p,
                                                    vb)
        m = m_safe
    return acc / l.clamp_min(1e-30)[..., None]


def _quantize_kv(x: torch.Tensor):
    """(B, R, S, hd) -> int8 values + (B, R, S, 1) f32 scales (rowwise)."""
    q = quantize_rowwise(x.float())
    return q.values, q.scales


def _dequantize_kv(vals, scale, dtype):
    return (vals.float() * scale).to(dtype)


def attention(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    cache: KVCacheView | None = None,
    cache_index=None,  # int or 0-d tensor: write offset (decode)
    make_cache: bool = False,  # prefill: also return the filled cache
    cache_len: int | None = None,
    cache_dtype: str = "bfloat16",
    attn_impl: str = "blocked",  # "blocked" | "flash" (the CUDA kernel)
):
    """Returns (out (B, S, D), new_cache | None).

    Decode writes the new rows into `cache` IN PLACE (where the reference's
    `dynamic_update_slice` makes a new array) and returns that same view;
    a write past the cache's end raises instead of being clamped.
    """
    B, S, D = x.shape
    hd = cfg.head_dim
    rep_kv = cfg.rep_kv_heads
    G = cfg.n_heads // rep_kv

    q, k, v = _project_qkv(p, x, cfg, positions)

    new_cache = None
    if cache is not None:
        # ---- decode: append at cache_index, attend over the whole cache --
        idx = int(cache_index)
        S_max = cache.k.shape[2]
        if not 0 <= idx <= S_max - S:
            raise IndexError(f"cache_index {idx} + {S} rows past the cache "
                             f"length {S_max}")
        kc = k.movedim(1, 2)  # (B, rep_kv, S, hd)
        vc = v.movedim(1, 2)
        rows = slice(idx, idx + S)
        if cache.k_scale is not None:
            kq, ks = _quantize_kv(kc)
            vq, vs = _quantize_kv(vc)
            cache.k[:, :, rows] = kq
            cache.v[:, :, rows] = vq
            cache.k_scale[:, :, rows] = ks
            cache.v_scale[:, :, rows] = vs
            k_full = _dequantize_kv(cache.k, cache.k_scale, x.dtype)
            v_full = _dequantize_kv(cache.v, cache.v_scale, x.dtype)
        else:
            cache.k[:, :, rows] = kc.to(cache.k.dtype)
            cache.v[:, :, rows] = vc.to(cache.v.dtype)
            k_full, v_full = cache.k, cache.v
        new_cache = cache
        q5 = q.movedim(1, 2).reshape(B, rep_kv, G, S, hd)
        s = torch.einsum("brgqd,brkd->brgqk", q5.float() * hd**-0.5,
                         k_full.float())
        pos = torch.arange(S_max, device=x.device)
        valid = pos[None, :] <= idx + torch.arange(S, device=x.device)[:, None]
        s = s.masked_fill(~valid, float("-inf"))
        out5 = torch.einsum("brgqk,brkd->brgqd", torch.softmax(s, dim=-1),
                            v_full.float())
    else:
        # ---- prefill (and the train-mode forward) ------------------------
        q5 = q.movedim(1, 2).reshape(B, rep_kv, G, S, hd)
        kT = k.movedim(1, 2)  # (B, rep_kv, S, hd)
        vT = v.movedim(1, 2)
        if attn_impl == "flash":
            # fold (rep_kv, G) into heads and repeat kv G times, as the
            # reference does before its Pallas kernel
            outf = ops.flash_attention(
                q5.reshape(B, rep_kv * G, S, hd),
                kT.repeat_interleave(G, dim=1),
                vT.repeat_interleave(G, dim=1), causal=True)
            out5 = outf.reshape(B, rep_kv, G, S, hd)
        elif attn_impl == "blocked":
            out5 = gqa_blocked_attention(q5, kT, vT, causal=True)
        else:
            raise ValueError(f"attn_impl {attn_impl!r}: blocked or flash")
        if make_cache:
            pad = (cache_len or S) - S
            kc = F.pad(kT, (0, 0, 0, pad))
            vc = F.pad(vT, (0, 0, 0, pad))
            if cache_dtype == "int8":
                kq, ks = _quantize_kv(kc)
                vq, vs = _quantize_kv(vc)
                new_cache = KVCacheView(kq, vq, ks, vs)
            else:
                dt = getattr(torch, cache_dtype)
                new_cache = KVCacheView(kc.to(dt), vc.to(dt), None, None)

    out = out5.reshape(B, rep_kv * G, S, hd).movedim(1, 2)
    out = out.reshape(B, S, cfg.n_heads * hd).to(x.dtype)
    return linear(p["wo"], out), new_cache
