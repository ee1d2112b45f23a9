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
from repro_torch.distributed.sharding import (
    block_of,
    constrain,
    is_dtensor,
    matmul,
    settled,
    to_placements,
    without_dim,
)

_DRAW_ELEMS = 1 << 26  # float32 draws per slab (256 MB)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(gen: torch.Generator, shape: tuple, scale: float, dtype,
           device) -> torch.Tensor:
    """`scale * N(0, 1)` of `shape` in `dtype`, drawn in float32 slabs
    (on `meta`, the shape alone: nothing is drawn)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
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
    for the card: the segment lengths are counted on the device.

    With `start` (an int), `table` is one block of a larger table's rows,
    from row `start`: an id outside the block gathers zeros, and the
    backward sums only the rows whose ids fall in the block."""

    @staticmethod
    def forward(table, ids, start):
        if start is None:
            return table[ids]
        local, inside = _in_block(ids, start, table.shape[0])
        return torch.where(inside[..., None], table[local], 0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, ids, start = inputs
        ctx.save_for_backward(ids)
        ctx.n_rows, ctx.start = table.shape[0], start

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return _sorted_segment_sum(grad, ids, ctx.n_rows, ctx.start), \
            None, None


def _in_block(ids, start: int, n_rows: int):
    """(ids - start where inside the block of `n_rows` rows, else 0;
    inside)."""
    local = ids - start
    inside = (local >= 0) & (local < n_rows)
    return torch.where(inside, local, 0), inside


def _sorted_segment_sum(grad, ids, n_rows: int,
                        start: int | None = None) -> torch.Tensor:
    """(n_rows, ...) sums of `grad`'s rows by id: stably sorted, a segment
    at a time. With `start`, the ids are global and the sums those of
    the block of `n_rows` from `start`: the rows of other ids sort after
    the block's (as id `n_rows`), and no segment sums them."""
    flat = ids.reshape(-1)
    segments = n_rows
    if start is not None:
        local, inside = _in_block(flat, start, n_rows)
        flat = torch.where(inside, local, n_rows)
        segments += 1
    order = torch.argsort(flat, stable=True)
    rows = grad.reshape(flat.numel(), -1)[order]
    lengths = torch.zeros(segments, dtype=torch.long,
                          device=flat.device).index_add_(
        0, flat, torch.ones_like(flat))
    sums = torch.segment_reduce(rows, "sum", lengths=lengths[:n_rows],
                                axis=0, unsafe=True)
    return sums.reshape((n_rows,) + grad.shape[ids.dim():])


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]` (ids long and in range) whose gradient is the same bits
    on every run: PyTorch's own backward of an index accumulates repeated
    ids in a varying order on the CPU.

    A DTensor table runs on each rank's block: its row block (every
    other mesh dim gathered), the ids of the rank's batch block, a masked
    local gather left as a pending sum over the mesh dim that shards the
    rows (the caller resolves it: `constrain`), and a backward that sums
    the rank's own rows, its gradient pending over the mesh dims that
    shard the ids, for DTensor to reduce onto the table's placement."""
    if not is_dtensor(table):
        return _GatherRows.apply(table, ids, None)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    blk = block_of(table, 0)
    i = None if blk is None else blk[0]
    table = to_placements(table, mesh, tuple(
        Shard(0) if j == i else Replicate() for j in range(mesh.ndim)))
    place = without_dim(ids.placements, i) if is_dtensor(ids) \
        else (Replicate(),) * mesh.ndim
    ids = to_placements(ids, mesh, place)
    grad_place = [Shard(0) if j == i else Partial()
                  if isinstance(place[j], Shard) else Replicate()
                  for j in range(mesh.ndim)]
    out = _GatherRows.apply(table.to_local(grad_placements=grad_place),
                            ids.to_local(), None if blk is None else blk[1])
    return DTensor.from_local(out, mesh, [
        Partial() if j == i else p for j, p in enumerate(place)],
        run_check=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_rms_norm(dim: int, dtype, device, lead: tuple = ()) -> torch.Tensor:
    return torch.ones(lead + (dim,), dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    if block_of(xf, -1) is None:
        var = (xf * xf).mean(-1, keepdim=True)
    else:  # a sharded last dim (mamba2's gated norm): all-reduce the sum
        var = settled((xf * xf).sum(-1, keepdim=True)) / xf.shape[-1]
    out = xf * torch.rsqrt(var + eps)
    del xf  # a float32 copy of a bfloat16 `x` goes before the next product
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
    y = matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_inv_freq(cfg: ModelConfig, device=None) -> torch.Tensor:
    """1 / theta ** (2i / rot), float32. The power is taken in float64 and
    rounded: XLA's float32 power is the correctly rounded one, torch's
    float32 `pow` is not (one frequency of theta 1e6 at rot 128 lands an
    ulp off), so this gives the reference's bits."""
    rot = int(cfg.head_dim * cfg.rope_fraction)
    assert rot % 2 == 0
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    theta = torch.full((), cfg.rope_theta, dtype=torch.float32,
                       device=device)
    return 1.0 / torch.pow(theta.double(), exps.double()).float()


def rope_angles(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """positions: standard (B, S) int, or M-RoPE (3, B, S) -> angles
    (B, S, rot/2) f32.

    M-RoPE computes every component's angles, `pos * inv_freq`, and takes
    component i for the `mrope_sections[i]` frequencies: the same products
    as the reference, so the same float32 bits."""
    inv_freq = rope_inv_freq(cfg, positions.device)
    if cfg.rope_style == "mrope":
        if positions.dim() != 3 or positions.shape[0] != 3:
            raise ValueError(f"M-RoPE needs (3, B, S) positions, got "
                             f"{tuple(positions.shape)}")
        ang3 = positions[..., None].float() * inv_freq  # (3, B, S, rot/2)
        idx = torch.cat([torch.full((s,), i, dtype=torch.long,
                                    device=positions.device)
                         for i, s in enumerate(cfg.mrope_sections)])
        return ang3.gather(0, idx.expand(ang3.shape[1:])[None])[0]
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
    h = constrain(h, ("act_batch", None, "act_mlp"))
    return linear(p["wo"], h)
