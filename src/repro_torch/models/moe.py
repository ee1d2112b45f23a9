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
from repro_torch.distributed.sharding import (
    act_placements,
    is_dtensor,
    on_local,
    settled,
    to_placements,
)
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
    gates = torch.softmax(xg.float() @ router, dim=-1)
    # lax.top_k: largest first, ties to the lower index
    topi = torch.sort(gates, dim=-1, descending=True, stable=True).indices[
        ..., :K]
    topw = gates.gather(-1, topi)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)

    slots = torch.arange(cap, device=xg.device)
    # the carried counts and sums start from slot 0's own terms (0 + t is
    # t), so each is made like the routed tensors: a DTensor's block
    counts = dispatch = combine = None
    for j in range(K):  # slot j claims capacity after slots < j
        m = F.one_hot(topi[..., j], E).float()  # (G, S, E)
        if counts is None:
            counts = torch.zeros_like(m[:, :1])  # (G, 1, E)
        pos = torch.cumsum(m, dim=1) - m + counts  # position within expert
        in_cap = (pos < cap) * m
        counts = counts + m.sum(dim=1, keepdim=True)
        # one_hot of a position past the last slot is all zeros
        oh_pos = (pos.to(torch.int32)[..., None] == slots).float()
        d_j = in_cap[..., None] * oh_pos  # (G, S, E, cap)
        c_j = d_j * topw[..., j][..., None, None]
        if dispatch is None:
            dispatch, combine = d_j.to(torch.bfloat16), c_j
        else:
            dispatch = dispatch + d_j.to(torch.bfloat16)
            combine = combine + c_j
    return Routing(gates, topi, topw, dispatch, combine)


def _experts(dispatch, combine, xg, wi, wg, wo, act: str,
             pending_x: bool = False):
    """The dispatch, expert and combine products: (G, S, D) float32. With
    `pending_x`, `xg`'s gradient is this rank's part of a sum across
    ranks (its experts' part), unrounded where `xg` is float32 and
    rounded to bfloat16 by the caller once summed (`_BfloatGrad`), as
    the whole product rounds it once."""
    bf16 = torch.bfloat16
    expert_in = (_Dispatch.apply(dispatch, xg) if pending_x else
                 torch.einsum("gsec,gsd->egcd", dispatch, xg.to(bf16)))
    h = torch.einsum("egcd,edf->egcf", expert_in, wi.to(bf16))
    if act == "swiglu":
        g = torch.einsum("egcd,edf->egcf", expert_in, wg.to(bf16))
        h = F.silu(g.float()).to(h.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    out_e = torch.einsum("egcf,efd->egcd", h, wo.to(bf16))
    return torch.einsum("egcd,gsec->gsd", out_e.float(), combine)


class _Dispatch(torch.autograd.Function):
    """``einsum("gsec,gsd->egcd", dispatch, x.to(bfloat16))`` whose
    gradient to `x` is the float32 product, unrounded."""

    @staticmethod
    def forward(ctx, dispatch, x):
        ctx.save_for_backward(dispatch)
        return torch.einsum("gsec,gsd->egcd", dispatch, x.to(torch.bfloat16))

    @staticmethod
    def backward(ctx, g):
        (dispatch,) = ctx.saved_tensors
        return None, torch.einsum("gsec,egcd->gsd", dispatch.float(),
                                  g.float())


class _BfloatGrad(torch.autograd.Function):
    """The identity, whose gradient is summed across ranks (a pending
    sum settled) and then rounded to bfloat16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return settled(g).to(torch.bfloat16).to(g.dtype)


def _experts_on_blocks(dispatch, combine, xg, w: list, act: str):
    """`_experts` over DTensors, each rank on its blocks, as the
    reference's sharding constraints lay them out: the groups over the
    batch's mesh dims (where they divide), the experts over the model
    axis, a group's tokens and the expert weights' inner dims whole (an
    FSDP weight is gathered). The result is pending over the experts'
    mesh dim; the input's and the weights' gradients are pending over the
    mesh dims that the rank's blocks of the other operands split."""
    from torch.distributed.tensor import Partial

    groups = act_placements(xg, ("act_batch", None, None))
    routed = act_placements(dispatch, ("act_batch", None, "act_experts",
                                       None))
    experts = act_placements(w[0], ("act_experts", None, None))
    sharded = [p.is_shard() for p in experts]

    def pending(place, over):
        return [Partial() if o else p for p, o in zip(place, over)]

    w_grad = pending(experts, [p.is_shard() for p in groups])
    ws = [t for t in w if t is not None]

    def local(d, c, x, wi, *rest):
        return (_experts(d, c, x, wi, rest[0] if len(rest) == 2 else None,
                         rest[-1], act, pending_x=True),)

    return on_local(local, [dispatch, combine, _BfloatGrad.apply(xg), *ws],
                    [routed, routed, groups] + [experts] * len(ws),
                    [pending(groups, sharded)],
                    [None, None, pending(groups, sharded)]
                    + [w_grad] * len(ws))[0]


def moe_layer(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, D) -> (y (B, S, D), aux_loss 0-d f32): capacity-based
    top-k dispatch, the shared expert added where the config has one, and
    the GShard load-balancing loss."""
    B, S, D = x.shape
    E = cfg.n_experts
    gsz, cap = capacity(cfg, B * S)
    if is_dtensor(x):  # the batch over the groups' mesh dims, or whole
        x = to_placements(x, x.device_mesh, act_placements(
            x, ("act_batch", None, None), (B * S // gsz, gsz, D)))
    xg = x.reshape(-1, gsz, D)
    r = route(p["router"], xg, cfg, cap)

    w = [p["wi"], p["wg"] if cfg.act == "swiglu" else None, p["wo"]]
    if is_dtensor(xg):
        y = _experts_on_blocks(r.dispatch, r.combine, xg, w, cfg.act)
    else:
        y = _experts(r.dispatch, r.combine, xg, *w, cfg.act)
    y = y.reshape(B, S, D).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], x, cfg)

    me = r.gates.mean(dim=1)  # (G, E) mean gate probability
    ce = F.one_hot(r.topi[..., 0], E).float().mean(dim=1)  # dispatch frac
    aux = E * (me * ce).sum(-1).mean()
    return y, aux
