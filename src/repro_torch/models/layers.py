"""Shared LM layers: RMS norm, linear, RoPE (standard and partial), MLPs.

The port of `repro/models/layers.py`. Params are plain dicts of tensors in
the reference's layout (`linear` weights are (din, dout)); every function
is pure. Init functions draw from an explicit `torch.Generator` on the
target device; `lead` prepends axes (the stacked `n_layers` axis), and
the draws go a slab at a time so a full-size model never holds a float32
copy of a whole stacked weight.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_DRAW_ELEMS = 1 << 26  # float32 draws per slab (256 MB)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(gen: torch.Generator, shape: tuple, scale: float, dtype,
           device) -> torch.Tensor:
    """`scale * N(0, 1)` of `shape` in `dtype`, drawn in float32 slabs."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1, shape[-1])
    rows = max(1, _DRAW_ELEMS // max(shape[-1], 1))
    for lo in range(0, flat.shape[0], rows):
        slab = flat[lo:lo + rows]
        slab.copy_(scale * torch.randn(slab.shape, generator=gen,
                                       device=device))
    return out


# ---------------------------------------------------------------------------
# gathers
# ---------------------------------------------------------------------------
class _GatherRows(torch.autograd.Function):
    """`table[ids]` for in-range long ids, with a deterministic backward:
    the output gradient's rows are stably sorted by id and summed a
    segment (one table row) at a time, in batch order. Nothing in it waits
    for the card: the segment lengths are counted on the device."""

    @staticmethod
    def forward(table, ids):
        return table[ids]

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, ids = inputs
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        rows = grad.reshape(flat.numel(), -1)[order]
        lengths = torch.zeros(ctx.n_rows, dtype=torch.long,
                              device=flat.device).index_add_(
            0, flat, torch.ones_like(flat))
        sums = torch.segment_reduce(rows, "sum", lengths=lengths, axis=0,
                                    unsafe=True)
        return sums.reshape((ctx.n_rows,) + grad.shape[ids.dim():]), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]` (ids long and in range) whose gradient is the same bits
    on every run: PyTorch's own backward of an index accumulates repeated
    ids in a varying order on the CPU."""
    return _GatherRows.apply(table, ids)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_rms_norm(dim: int, dtype, device, lead: tuple = ()) -> torch.Tensor:
    return torch.ones(lead + (dim,), dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------
def init_linear(gen, din: int, dout: int, dtype, device, bias: bool = False,
                scale: float | None = None, lead: tuple = ()) -> dict:
    scale = din**-0.5 if scale is None else scale
    p = {"w": normal(gen, lead + (din, dout), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros(lead + (dout,), dtype=dtype, device=device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_inv_freq(cfg: ModelConfig, device=None) -> torch.Tensor:
    rot = int(cfg.head_dim * cfg.rope_fraction)
    assert rot % 2 == 0
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                        device=device), exps)


def rope_angles(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """positions (B, S) int -> angles (B, S, rot/2) f32 (standard RoPE)."""
    if cfg.rope_style == "mrope":
        raise NotImplementedError(
            "M-RoPE (the VLM family) is not ported yet; see ROADMAP.md, "
            "queue A.5")
    inv_freq = rope_inv_freq(cfg, positions.device)
    return positions[..., None].float() * inv_freq


def apply_rope(x: torch.Tensor, angles: torch.Tensor,
               fraction: float) -> torch.Tensor:
    """x (B, S, H, hd), angles (B, S, rot/2): rotates the first
    rot = hd * fraction dims (chatglm3's partial rotary: fraction 0.5)."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2].float(), xr[..., rot // 2:].float()
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.cat([r1.to(x.dtype), r2.to(x.dtype)], dim=-1)
    if rot < hd:
        out = torch.cat([out, xp], dim=-1)
    return out


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def init_mlp(gen, cfg: ModelConfig, device, d_ff: int | None = None,
             lead: tuple = ()) -> dict:
    d_ff = cfg.d_ff if d_ff is None else d_ff
    dt = param_dtype(cfg)
    p = {"wi": init_linear(gen, cfg.d_model, d_ff, dt, device, lead=lead),
         "wo": init_linear(gen, d_ff, cfg.d_model, dt, device, lead=lead)}
    if cfg.act == "swiglu":
        p["wg"] = init_linear(gen, cfg.d_model, d_ff, dt, device, lead=lead)
    return p


def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = linear(p["wi"], x)
    if cfg.act == "swiglu":
        h = F.silu(linear(p["wg"], x)) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return linear(p["wo"], h)
