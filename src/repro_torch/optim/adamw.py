"""AdamW with configurable state precision (mirrors `repro/optim/adamw.py`).

State dtypes:
  float32  — standard.
  bfloat16 — halves optimizer memory; the update math stays float32.
  int8     — the iMARS quantization idea applied to optimizer memory:
             per-row symmetric int8 over the last axis. `nu` (second
             moment, non-negative, huge dynamic range) is stored as
             sqrt(nu) before quantization, which compresses its range
             into int8's.

Quantized leaves keep the parameter's rank (values: int8 of its shape,
scales: last dim collapsed to 1). Trees are nested dicts and lists of
tensors in the reference's layout (`utils.tree_map` walks them in
`jax.tree_util` order).

Every call is out of place: it returns new tensors and writes none it was
given. A serving engine that holds a parameter tensor (`RecSysEngine`
keeps its build parameters) therefore never sees the optimizer change it.
`torch.round` rounds half to even and a bfloat16 cast rounds to nearest
even, as JAX's do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.utils import tree_leaves, tree_map

INT8_MAX = 127.0


@dataclasses.dataclass
class QuantState:
    """Same-rank int8 container: values (..., d) int8, scales (..., 1) f32."""

    values: torch.Tensor
    scales: torch.Tensor


@dataclasses.dataclass
class AdamWState:
    mu: Any
    nu: Any
    count: torch.Tensor  # () int32


def _q(x: torch.Tensor) -> QuantState:
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp(min=1e-12) / INT8_MAX
    v = torch.round(x / scale).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    return QuantState(values=v, scales=scale.to(torch.float32))


def _dq(q: QuantState) -> torch.Tensor:
    return q.values.to(torch.float32) * q.scales


def _encode(x: torch.Tensor, dtype: str, sqrt_transform: bool = False):
    if dtype == "int8":
        return _q(torch.sqrt(x) if sqrt_transform else x)
    return x.to(getattr(torch, dtype))


def _decode(x, dtype: str, sqrt_transform: bool = False) -> torch.Tensor:
    if dtype == "int8":
        d = _dq(x)
        return torch.square(d) if sqrt_transform else d
    return x.to(torch.float32)


def init_adamw_state(params: Any, state_dtype: str = "float32"
                     ) -> AdamWState:
    """Zero moments in `state_dtype` beside each parameter, count 0 (on
    the parameters' device)."""
    def zero(p, sqrt_transform=False):  # a DTensor beside a DTensor
        z = torch.zeros_like(p, dtype=torch.float32)
        return _encode(z, state_dtype, sqrt_transform)

    device = tree_leaves(params)[0].device
    return AdamWState(
        mu=tree_map(zero, params),
        nu=tree_map(lambda p: zero(p, True), params),
        count=torch.zeros((), dtype=torch.int32, device=device))


def adamw_update(
    grads: Any,
    state: AdamWState,
    params: Any,
    lr: torch.Tensor | float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    state_dtype: str = "float32",
):
    """One AdamW step -> (new params, new state), both new trees."""
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c

    def upd(g, m_s, v_s, p):
        g = g.to(torch.float32)
        m = b1 * _decode(m_s, state_dtype) + (1 - b1) * g
        v = b2 * _decode(v_s, state_dtype, True) + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        step = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(
            torch.float32)
        new_p = (p.to(torch.float32) - lr * step).to(p.dtype)
        return new_p, _encode(m, state_dtype), _encode(v, state_dtype, True)

    out = tree_map(lambda g, m, v, p: _by_slabs(upd, g, m, v, p),
                   grads, state.mu, state.nu, params)
    new_params, new_mu, new_nu = (tree_map(lambda _, o: o[i], grads, out)
                                  for i in range(3))
    return new_params, AdamWState(mu=new_mu, nu=new_nu, count=count)


_SLAB_ELEMS = 1 << 26  # elements a slab: 256 MB of each float32 temporary


def _by_slabs(upd, g, m_s, v_s, p):
    """`upd(g, m_s, v_s, p)` a slab of leading-dim rows at a time where `p`
    is larger than `_SLAB_ELEMS` (and, for a DTensor, whole along dim 0),
    the slabs' results concatenated: the same bits (the update is
    elementwise, the int8 scales are a row's), with the float32
    temporaries of one slab instead of the whole leaf (Qwen2-VL-72B's
    embedding holds 1.25 B params: ~5 GB a temporary)."""
    if p.dim() < 2 or p.numel() <= _SLAB_ELEMS or any(
            getattr(pl, "dim", None) == 0
            for pl in getattr(p, "placements", ())):
        return upd(g, m_s, v_s, p)
    rows = max(1, _SLAB_ELEMS * p.shape[0] // p.numel())

    def split(t):
        if isinstance(t, QuantState):
            return [QuantState(values=a, scales=b) for a, b in
                    zip(t.values.split(rows), t.scales.split(rows))]
        return t.split(rows)

    outs = [upd(*parts) for parts in zip(*(split(t) for t in
                                           (g, m_s, v_s, p)))]

    def cat(items):
        if isinstance(items[0], QuantState):
            return QuantState(values=torch.cat([q.values for q in items]),
                              scales=torch.cat([q.scales for q in items]))
        return torch.cat(items)

    return tuple(cat([o[i] for o in outs]) for i in range(3))


# ---------------------------------------------------------------------------
# schedules & clipping
# ---------------------------------------------------------------------------
def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step): linear warm-up to `base_lr`, then a cosine decay floored
    at a tenth of it; a float32 0-d tensor on the step's device."""
    def lr(step):
        step = (step.to(torch.float32) if isinstance(step, torch.Tensor)
                else torch.tensor(float(step), dtype=torch.float32))
        warm = base_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm,
                           torch.clamp(cos, min=0.1 * base_lr))

    return lr


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, the leaves summed in the
    reference's order (dict keys sorted)."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(tree: Any, max_norm: float):
    """-> (tree scaled to at most `max_norm` in global norm, the norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    tree), norm
