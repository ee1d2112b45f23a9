"""Mamba2 (state-space duality, SSD) block: the chunked scan of training
and prefill, and the O(1) recurrent decode step.

The port of `repro/models/ssm.py`, after the ssd_minimal discrete
formulation of arXiv:2405.21060 (Dao & Gu 2024). The reference's
`lax.scan` over chunks is a loop over chunks. The float32 islands are the
reference's: `dt`, `A`, the chunk states and the recurrent state, and `y`
up to the gated RMSNorm; the conv carry is float32 and decode's window is
concatenated in the input's dtype. `L` is right-padded to a multiple of
the chunk.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    block_of,
    constrain,
    einsum,
    matmul,
    on_blocks,
    on_local,
    pad_zeros,
    split_blocks,
    split_ready,
    without_dim,
)
from repro_torch.models.layers import normal, param_dtype, rms_norm


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def init_mamba2(gen, cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    dt = param_dtype(cfg)
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    cd = conv_dim(cfg)
    d_in = 2 * di + 2 * g * n + h

    def fixed(v: torch.Tensor) -> torch.Tensor:  # the same row per layer
        return v.to(device).expand(lead + v.shape).clone()

    # the reference's float32 constants: softplus^-1 of the dt range, and
    # A = -(1 .. 16)
    dt_range = torch.linspace(1e-3, 0.1, h, dtype=torch.float32)
    return {
        "in_proj": normal(gen, lead + (d, d_in), d**-0.5, dt, device),
        "conv_w": normal(gen, lead + (cfg.ssm_conv, cd), 0.1, dt, device),
        "conv_b": torch.zeros(lead + (cd,), dtype=dt, device=device),
        "dt_bias": fixed(torch.log(torch.exp(dt_range) - 1.0)),
        "A_log": fixed(torch.log(torch.linspace(1.0, 16.0, h,
                                                dtype=torch.float32))),
        "D": torch.ones(lead + (h,), device=device),
        "norm_w": torch.ones(lead + (di,), dtype=dt, device=device),
        "out_proj": normal(gen, lead + (di, d), di**-0.5, dt, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (K, C) -> (B, S, C), the K
    shifted views summed in the reference's order."""
    K, S = w.shape[0], x.shape[1]
    xp = pad_zeros(x, 1, before=K - 1)
    out = 0
    for i in range(K):
        out = out + xp[:, i:i + S, :] * w[i]
    return out + b


def _segsum(z: torch.Tensor) -> torch.Tensor:
    """z (..., Q) -> (..., Q, Q): out[i, j] = sum_{j < s <= i} z[s], -inf
    above the diagonal (the SSD 1-semiseparable decay matrix)."""
    Q = z.shape[-1]
    cs = on_blocks(lambda t: torch.cumsum(t, dim=-1), z, -1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=z.device).tril()
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B_, C_, chunk: int, init_state=None):
    """x (B, L, H, P), dt (B, L, H) f32 post-softplus, A (H,) f32
    negative, B_ / C_ (B, L, G, N), init_state (B, H, P, N) or None ->
    (y (B, L, H, P) f32, final_state (B, H, P, N) f32)."""
    Bsz, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    hpg = H // G
    pad = (-L) % chunk
    if pad:
        x, dt, B_, C_ = (pad_zeros(t, 1, after=pad)
                         for t in (x, dt, B_, C_))
    nc = (L + pad) // chunk

    xf = x.float().reshape(Bsz, nc, chunk, H, P)
    dtf = dt.float().reshape(Bsz, nc, chunk, H)
    Bh = B_.float().repeat_interleave(hpg, dim=2).reshape(
        Bsz, nc, chunk, H, N)
    Ch = C_.float().repeat_interleave(hpg, dim=2).reshape(
        Bsz, nc, chunk, H, N)

    dA_t = (dtf * A).movedim(-1, -2)  # (B, nc, H, Q)
    dA_cs = on_blocks(lambda t: torch.cumsum(t, dim=-1), dA_t, -1)
    xdt = xf * dtf[..., None]  # (B, nc, Q, H, P)

    # intra-chunk (quadratic within a chunk)
    Lmat = torch.exp(_segsum(dA_t))  # (B, nc, H, Q, Q)
    CB = einsum("bcqhn,bcshn->bchqs", Ch, Bh)
    y_diag = einsum("bchqs,bcshp->bcqhp", CB * Lmat, xdt)

    # each chunk's state
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)  # (B, nc, H, Q)
    states = einsum("bcqhn,bchq,bcqhp->bchpn", Bh, decay_states, xdt)

    # the inter-chunk recurrence, a chunk at a time: the state entering
    # each chunk, and the one leaving the last
    chunk_decay = torch.exp(dA_cs[..., -1])  # (B, nc, H)
    prev = (torch.zeros_like(states[:, 0])
            if init_state is None else init_state.float())
    entering = []
    for c in range(nc):
        entering.append(prev)
        prev = prev * chunk_decay[:, c, :, None, None] + states[:, c]
    state_in = torch.stack(entering, dim=1)  # (B, nc, H, P, N)

    # the carried state's contribution inside each chunk
    y_off = einsum("bcqhn,bchpn,bchq->bcqhp", Ch, state_in,
                   torch.exp(dA_cs))
    y = (y_diag + y_off).reshape(Bsz, nc * chunk, H, P)[:, :L]
    return y, prev


def _in_proj(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The in-projection of x (B, S, D) -> (z, [xBC] or [x, B, C], dt,
    and the conv weights and biases of those parts). Where a DTensor
    `in_proj`'s columns are sharded, each part is its own product with
    its own columns, sharded along them (`split_blocks`): the split of
    one product at boundaries the model axis does not divide would
    gather it, and the SSD would run on every head on every rank."""
    di, gn, h = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_heads
    if block_of(p["in_proj"], -1) is None:
        z, xbc, dt_raw = torch.split(matmul(x, p["in_proj"]),
                                     [di, conv_dim(cfg), h], dim=-1)
        return z, [xbc], dt_raw, [p["conv_w"]], [p["conv_b"]]
    z, *xbc, dt_raw = (matmul(x, w) for w in split_blocks(
        p["in_proj"], [di, di, gn, gn, h], -1))
    return (z, xbc, dt_raw, split_blocks(p["conv_w"], [di, gn, gn], -1),
            split_blocks(p["conv_b"], [di, gn, gn], -1))


def _ssd_heads(x, dt, A, B_, C_, chunk: int):
    """`ssd_chunked` on each rank's heads. Where a DTensor `x`'s heads
    are sharded over one mesh dim whose block holds whole groups of B
    and C (or there is one group), each rank runs the SSD on its own
    heads' plain blocks, as the reference's rank does; otherwise the
    whole call goes to DTensor (whose backward of the chunk einsums
    gathers the heads)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    blk = block_of(x, 2)
    if blk is None:
        return ssd_chunked(x, dt, A, B_, C_, chunk)
    i, place = blk[0], tuple(x.placements)
    m, (H, G) = x.device_mesh.shape[i], (x.shape[2], B_.shape[2])
    if G == 1:
        bc, bc_grad = without_dim(place, i), [
            Partial() if j == i else p for j, p in enumerate(place)]
    elif G % m == 0 and (H // m) % (H // G) == 0:
        bc, bc_grad = place, None
    else:
        return ssd_chunked(x, dt, A, B_, C_, chunk)
    # A is whole over the batch's mesh dims: its gradient is pending there
    heads = tuple(Shard(0) if j == i else Replicate()
                  for j in range(len(place)))
    a_grad = [Shard(0) if j == i else Partial() if isinstance(p, Shard)
              else p for j, p in enumerate(place)]
    state = tuple(Shard(1) if j == i else p for j, p in enumerate(place))
    return on_local(lambda *t: ssd_chunked(*t, chunk),
                    [x, dt, A, B_, C_], [place, place, heads, bc, bc],
                    [place, state], [None, None, a_grad, bc_grad, bc_grad])


def mamba2_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 conv_state=None, ssm_state=None, decode: bool = False):
    """x (B, S, D) -> (y (B, S, D), (conv_state, ssm_state)): the new
    float32 carries (B, K-1, conv_dim) and (B, H, P, N), new tensors."""
    B, S, _ = x.shape
    di, g, n, h = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    P, K = cfg.ssm_head_dim, cfg.ssm_conv

    z, xbc, dt_raw, conv_w, conv_b = _in_proj(p, x, cfg)
    if decode:
        if conv_state is None or ssm_state is None or S != 1:
            raise ValueError("decode takes one token and both carries")
        states = (conv_state,) if len(xbc) == 1 else split_blocks(
            conv_state, [di, g * n, g * n], -1)
        windows = [torch.cat([c.to(t.dtype), t], dim=1)
                   for c, t in zip(states, xbc)]
        conv_out = [(einsum("bkc,kc->bc", wd, w) + b)[:, None, :]
                    for wd, w, b in zip(windows, conv_w, conv_b)]
        tails = [wd[:, 1:] for wd in windows]
    else:
        conv_out = [_causal_conv(t, w, b)
                    for t, w, b in zip(xbc, conv_w, conv_b)]
        # the carry for a later decode: the last K-1 raw xBC inputs
        tails = [t[:, -(K - 1):] if S >= K - 1
                 else pad_zeros(t, 1, before=K - 1 - S) for t in xbc]
    new_conv = (tails[0] if len(tails) == 1
                else torch.cat(tails, dim=-1)).float()
    xc, B_, C_ = (F.silu(t) for t in (
        conv_out if len(conv_out) == 3
        else torch.split(conv_out[0], [di, g * n, g * n], dim=-1)))
    xh = xc.reshape(B, S, h, P)
    B_ = split_ready(B_, -1, g).reshape(B, S, g, n)
    C_ = split_ready(C_, -1, g).reshape(B, S, g, n)
    xh = constrain(xh, ("act_batch", None, "act_heads", None))

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])  # (H,)

    if decode:
        hpg = h // g
        Bh = B_[:, 0].repeat_interleave(hpg, dim=1).float()  # (B, H, N)
        Ch = C_[:, 0].repeat_interleave(hpg, dim=1).float()
        dA = torch.exp(dt[:, 0] * A)  # (B, H)
        xdt = xh[:, 0].float() * dt[:, 0][..., None]  # (B, H, P)
        new_ssm = (ssm_state.float() * dA[:, :, None, None]
                   + einsum("bhp,bhn->bhpn", xdt, Bh))
        y = einsum("bhpn,bhn->bhp", new_ssm, Ch)[:, None]
    else:
        y, new_ssm = _ssd_heads(xh, dt, A, B_, C_, cfg.ssm_chunk)

    y = y + p["D"][:, None] * xh.float()
    y = y.reshape(B, S, di).to(x.dtype)
    # gated RMSNorm (mamba2's norm(y * silu(z)))
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm_w"],
                 cfg.norm_eps)
    return matmul(y, p["out_proj"]), (new_conv, new_ssm)


def init_decode_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                      device=None):
    """One layer's zero (conv_state, ssm_state) for decode."""
    return (torch.zeros((batch, cfg.ssm_conv - 1, conv_dim(cfg)),
                        dtype=dtype, device=device),
            torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=dtype, device=device))

