"""Mixture-of-Experts with GShard-style capacity dispatch.

The port of `repro/models/moe.py`. Tokens are routed in fixed-size groups
of `MOE_GROUP_SIZE`; each expert takes at most `cap` tokens a group, and
a token over capacity passes through the residual unharmed. Routing keeps
the reference's arithmetic: a float32 router and softmax, top-k with ties
to the lower expert index (a stable sort; `torch.topk` does not promise
that order), the sequential slot claim over `j in range(K)` with a float32
cumsum, one-hot dispatch in bfloat16 and combine weights in float32. The
dispatch, expert and combine products are the reference's einsums, with
bfloat16 operands for the experts even where the model is float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import init_mlp, mlp, normal, param_dtype

MOE_GROUP_SIZE = 1024  # tokens per dispatch group


def init_moe(gen, cfg: ModelConfig, device, lead: tuple = ()) -> dict:
    dt = param_dtype(cfg)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    scale = d**-0.5
    p = {
        "router": normal(gen, lead + (d, e), scale, torch.float32, device),
        "wi": normal(gen, lead + (e, d, f), scale, dt, device),
        "wo": normal(gen, lead + (e, f, d), f**-0.5, dt, device),
    }
    if cfg.act == "swiglu":
        p["wg"] = normal(gen, lead + (e, d, f), scale, dt, device)
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, device,
                               d_ff=cfg.d_ff * cfg.n_shared_experts,
                               lead=lead)
    return p


class Routing(NamedTuple):
    """One call's routing, grouped: gates (G, S, E) f32; topi (G, S, K)
    long; topw (G, S, K) f32, renormalized; dispatch (G, S, E, cap) bf16
    one-hot of the (expert, slot) each kept choice took; combine (G, S, E,
    cap) f32, the same one-hot times the choice's weight."""

    gates: torch.Tensor
    topi: torch.Tensor
    topw: torch.Tensor
    dispatch: torch.Tensor
    combine: torch.Tensor


def capacity(cfg: ModelConfig, tokens: int) -> tuple[int, int]:
    """(group size, slots an expert takes a group) for `tokens` tokens."""
    gsz = min(MOE_GROUP_SIZE, tokens)
    if tokens % gsz:
        raise ValueError(f"{tokens} tokens are not whole groups of {gsz}")
    cap = max(1, int(gsz * cfg.moe_top_k * cfg.capacity_factor
                     / cfg.n_experts))
    return gsz, cap


def route(router: torch.Tensor, xg: torch.Tensor, cfg: ModelConfig,
          cap: int) -> Routing:
    """Routing of grouped tokens xg (G, S, D) over `router` (D, E)."""
    E, K = cfg.n_experts, cfg.moe_top_k
    G, S, _ = xg.shape
    gates = torch.softmax(xg.float() @ router, dim=-1)
    # lax.top_k: largest first, ties to the lower index
    topi = torch.sort(gates, dim=-1, descending=True, stable=True).indices[
        ..., :K]
    topw = gates.gather(-1, topi)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)

    slots = torch.arange(cap, device=xg.device)
    counts = torch.zeros((G, 1, E), device=xg.device)
    dispatch = torch.zeros((G, S, E, cap), dtype=torch.bfloat16,
                           device=xg.device)
    combine = torch.zeros((G, S, E, cap), device=xg.device)
    for j in range(K):  # slot j claims capacity after slots < j
        m = F.one_hot(topi[..., j], E).float()  # (G, S, E)
        pos = torch.cumsum(m, dim=1) - m + counts  # position within expert
        in_cap = (pos < cap) * m
        counts = counts + m.sum(dim=1, keepdim=True)
        # one_hot of a position past the last slot is all zeros
        oh_pos = (pos.to(torch.int32)[..., None] == slots).float()
        d_j = in_cap[..., None] * oh_pos  # (G, S, E, cap)
        dispatch = dispatch + d_j.to(torch.bfloat16)
        combine = combine + d_j * topw[..., j][..., None, None]
    return Routing(gates, topi, topw, dispatch, combine)


def moe_layer(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, D) -> (y (B, S, D), aux_loss 0-d f32): capacity-based
    top-k dispatch, the shared expert added where the config has one, and
    the GShard load-balancing loss."""
    B, S, D = x.shape
    E = cfg.n_experts
    gsz, cap = capacity(cfg, B * S)
    xg = x.reshape(-1, gsz, D)
    r = route(p["router"], xg, cfg, cap)

    bf16 = torch.bfloat16
    dispatch = constrain(r.dispatch, ("act_batch", None, "act_experts", None))
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xg.to(bf16))
    expert_in = constrain(expert_in, ("act_experts", "act_batch", None, None))
    h = torch.einsum("egcd,edf->egcf", expert_in, p["wi"].to(bf16))
    if cfg.act == "swiglu":
        g = torch.einsum("egcd,edf->egcf", expert_in, p["wg"].to(bf16))
        h = F.silu(g.float()).to(h.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    out_e = torch.einsum("egcf,efd->egcd", h, p["wo"].to(bf16))
    out_e = constrain(out_e, ("act_experts", "act_batch", None, None))

    y = torch.einsum("egcd,gsec->gsd", out_e.float(), r.combine)
    y = y.reshape(B, S, D).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], x, cfg)

    me = r.gates.mean(dim=1)  # (G, E) mean gate probability
    ce = F.one_hot(r.topi[..., 0], E).float().mean(dim=1)  # dispatch frac
    aux = E * (me * ce).sum(-1).mean()
    return y, aux
