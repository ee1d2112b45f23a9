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
    constrain,
    einsum,
    matmul,
    on_blocks,
    pad_zeros,
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
    prev = (torch.zeros((Bsz, H, P, N), device=x.device)
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


def mamba2_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 conv_state=None, ssm_state=None, decode: bool = False):
    """x (B, S, D) -> (y (B, S, D), (conv_state, ssm_state)): the new
    float32 carries (B, K-1, conv_dim) and (B, H, P, N), new tensors."""
    B, S, _ = x.shape
    di, g, n, h = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    P, K = cfg.ssm_head_dim, cfg.ssm_conv
    cd = conv_dim(cfg)

    zxbcdt = matmul(x, p["in_proj"])  # (B, S, 2 di + 2 g n + h)
    z, xBC, dt_raw = torch.split(zxbcdt, [di, cd, h], dim=-1)

    if decode:
        if conv_state is None or ssm_state is None or S != 1:
            raise ValueError("decode takes one token and both carries")
        window = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
        conv_out = (einsum("bkc,kc->bc", window, p["conv_w"])
                    + p["conv_b"])[:, None, :]
        new_conv = window[:, 1:].float()
    else:
        conv_out = _causal_conv(xBC, p["conv_w"], p["conv_b"])
        # the carry for a later decode: the last K-1 raw xBC inputs
        tail = (xBC[:, -(K - 1):] if S >= K - 1
                else pad_zeros(xBC, 1, before=K - 1 - S))
        new_conv = tail.float()
    xBC = F.silu(conv_out)
    xc, B_, C_ = torch.split(xBC, [di, g * n, g * n], dim=-1)
    xh = xc.reshape(B, S, h, P)
    B_ = B_.reshape(B, S, g, n)
    C_ = C_.reshape(B, S, g, n)
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
        y, new_ssm = ssd_chunked(xh, dt, A, B_, C_, cfg.ssm_chunk)

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

