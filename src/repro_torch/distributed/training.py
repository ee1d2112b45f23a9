"""Train steps (mirrors `repro/distributed/training.py`): the dense LM
step and the RecSys filtering-model step, each from a `TrainState`.

The LM step (`make_train_step`) accumulates gradients over the batch's
leading `accum` axis, optionally passes them through int8 compression
with error feedback (`optim/compression.py`), clips them to global norm
1, and applies AdamW at a warm-up + cosine learning rate, its moments in
`pcfg.opt_state_dtype`. Its loss (`lm_loss`) is the mean token NLL of the
train-mode forward (`models/transformer.py`: the blocked attention's
custom backward, each layer checkpointed under `remat="block"`) through
`chunked_cross_entropy`, which never holds the (B, S, V) float32 logits
for the backward: each sequence chunk's logits are recomputed there.

The RecSys step (`make_recsys_train_step`): full-softmax
`filtering_loss` and AdamW at a flat learning rate. Offline pretraining
and the online trainer (`serving/online.py`) run the same step, so the
model the trainer continues is the one the engine was built from.

Every step is a plain function of tensors: the gradient comes from
`torch.autograd.grad` over the parameter dict's leaves (`value_and_grad`,
as `jax.value_and_grad` gives the reference's), and the update is the
reference's own AdamW rule (`optim/adamw.py`), out of place. Loss and
metrics come back as 0-d tensors on the state's device; the caller syncs
when it reads them (the RecSys step queues without any host sync).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.distributed.sharding import (
    all_reduce,
    block_of,
    replicate_dim,
    to_placements,
    without_dim,
)
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.optim.compression import (
    compress_decompress,
    init_error_buffer,
)
from repro_torch.utils import resolve_device, to_device, tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: adamw.AdamWState
    step: torch.Tensor  # () int32
    err_buf: Any = None  # int8 grad-compression error feedback (LM only)


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """A training batch (numpy arrays or tensors) on `device`. Host arrays
    go through pinned buffers and non-blocking copies on a CUDA device, so
    staging a batch does not wait for the card."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.asarray(v))
            if device.type == "cuda":
                v = v.pin_memory()
        out[k] = v.to(device, non_blocking=True)
    return out


def value_and_grad(loss_fn: Callable) -> Callable:
    """``loss_fn(params, batch) -> 0-d loss`` to ``(params, batch) ->
    (loss, grads)``, grads a tree like params (zeros for a leaf the loss
    does not use, as JAX gives). The leaves are tracked through detached
    views, so the caller's tensors gain no grad state. One
    `torch.autograd.grad` pass: half the host time of
    `torch.func.grad_and_value` on this model's step."""

    def fn(params, batch):
        leaves = tree_leaves(params)
        tracked = [t.detach().requires_grad_(True) for t in leaves]
        it = iter(tracked)
        with torch.enable_grad():
            loss = loss_fn(tree_map(lambda _: next(it), params), batch)
        grads = torch.autograd.grad(loss, tracked, allow_unused=True)
        it = iter([torch.zeros_like(t) if g is None else g
                   for g, t in zip(grads, leaves)])
        return loss.detach(), tree_map(lambda _: next(it), params)

    return fn


# ---------------------------------------------------------------------------
# the LM: state, loss and step
# ---------------------------------------------------------------------------
def init_train_state(cfg: ModelConfig, pcfg: ParallelConfig,
                     generator: torch.Generator, device=None) -> TrainState:
    """Fresh LM training state on `device` (default `cuda`): parameters
    drawn from `generator` (which must live there), zero AdamW moments in
    `pcfg.opt_state_dtype`, step 0, and a zero float32 error buffer iff
    `pcfg.grad_compression`. On `meta` (generator None): shapes only."""
    device = resolve_device(device, allow_meta=True)
    params = tf.init_params(cfg, generator, device)
    return TrainState(
        params=params,
        opt=adamw.init_adamw_state(params, pcfg.opt_state_dtype),
        step=torch.zeros((), dtype=torch.int32, device=device),
        err_buf=init_error_buffer(params) if pcfg.grad_compression
        else None)


class _BlockNLL(torch.autograd.Function):
    """`_token_nll` over a vocabulary cut into blocks across the ranks of
    mesh dim `i`: `logits` is this rank's float32 block (..., Vb) of the
    columns from `start`, `labels` (...) the global ids. The row max, the
    sum of exponentials and the gold logit (0 from a rank whose block
    lacks the label) are each reduced over the group; the backward is
    this rank's block alone: softmax less the block's one-hot, times the
    incoming gradient. It may run twice (the CE chunks' checkpoint
    recomputes it in the backward)."""

    @staticmethod
    def forward(ctx, logits, labels, start, mesh, i):
        m = all_reduce(logits.amax(-1), "max", mesh, i)
        s = all_reduce(torch.exp(logits - m[..., None]).sum(-1), "sum",
                       mesh, i)
        lse = m + torch.log(s)
        local = labels.long() - start
        inside = (local >= 0) & (local < logits.shape[-1])
        local = torch.where(inside, local, 0)
        gold = logits.gather(-1, local[..., None])[..., 0]
        gold = all_reduce(torch.where(inside, gold, 0.0), "sum", mesh, i)
        ctx.save_for_backward(logits, local, inside, lse)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, local, inside, lse = ctx.saved_tensors
        grad = torch.exp(logits - lse[..., None])
        grad.scatter_add_(-1, local[..., None],
                          -inside[..., None].to(grad.dtype))
        return grad.mul_(g[..., None]), None, None, None, None


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logsumexp(logits) - logits[label] over the last axis, float32.
    A DTensor whose vocabulary one mesh dim shards runs on each rank's
    block (`_BlockNLL`), its result replicated over that dim; any other
    DTensor has its rows gathered whole first."""
    logits = logits.float()
    blk = block_of(logits, -1)
    if blk is None:
        logits = replicate_dim(logits, -1)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[..., None].long())[..., 0]
        return lse - gold
    from torch.distributed.tensor import DTensor

    i, start = blk
    mesh = logits.device_mesh
    place = without_dim(logits.placements, i)
    labels = to_placements(labels, mesh, place)
    nll = _BlockNLL.apply(logits.to_local(), labels.to_local(), start, mesh,
                          i)
    return DTensor.from_local(nll, mesh, place, run_check=False,
                              shape=labels.shape, stride=labels.stride())


def _ce_from_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Mean token NLL, float32. logits (..., V), labels (...)."""
    return _token_nll(logits, labels).mean()


def _chunk_nll(params, cfg, hc, lc):
    return _token_nll(tf.unembed(params, cfg, hc), lc).sum()


def chunked_cross_entropy(params, cfg: ModelConfig, hidden: torch.Tensor,
                          labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """hidden (B, S, D), labels (B, S) -> mean NLL, a sequence chunk of
    `chunk` at a time, each chunk checkpointed: its (B, chunk, V) logits
    are recomputed in the backward instead of saved. Unchunked where
    `chunk <= 0`, `S % chunk != 0` or `S == chunk`, as in the reference."""
    B, S, _ = hidden.shape
    if chunk <= 0 or S % chunk != 0 or S == chunk:
        return _ce_from_logits(tf.unembed(params, cfg, hidden), labels)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, S, chunk):
        total = total + checkpoint(
            _chunk_nll, params, cfg, hidden[:, lo:lo + chunk],
            labels[:, lo:lo + chunk], use_reentrant=False)
    return total / (B * S)


def lm_loss(params, cfg: ModelConfig, pcfg: ParallelConfig,
            batch: dict) -> tuple[torch.Tensor, dict]:
    """(loss, {"nll", "aux"}) of one microbatch (``tokens``, ``labels``
    (B, S), for the audio model (B, K, S); the VLM's ``vision_embeds``,
    ``vision_pos`` and ``positions`` when given); the aux loss is zero
    without experts. The audio model's loss is over its full (B, K, S, V)
    logits, unchunked, as in the reference."""
    out = tf.forward(params, cfg, batch, mode="train", remat=pcfg.remat,
                     logits_mode="none")
    labels = torch.as_tensor(batch["labels"], device=out.hidden.device)
    if cfg.family == "audio":
        logits = tf.unembed(params, cfg, out.hidden)  # (B, S, K, V)
        nll = _ce_from_logits(logits.movedim(2, 1), labels)
    else:
        nll = chunked_cross_entropy(params, cfg, out.hidden, labels,
                                    pcfg.logit_chunk)
    loss = nll + cfg.router_aux_weight * out.aux_loss
    return loss, {"nll": nll, "aux": out.aux_loss}


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                    shape: ShapeConfig, *, base_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    grad_shardings: Any = None
                    ) -> Callable[[TrainState, dict],
                                  tuple[TrainState, dict]]:
    """``train_step(state, batch) -> (state', metrics)``. Batch leaves
    (numpy or tensors) have a leading gradient-accumulation axis:
    tokens and labels (accum, mb, S) (audio: (accum, mb, K, S)), the
    VLM's vision_embeds (accum, mb, n_vis, D), vision_pos (accum, mb,
    n_vis) and positions (accum, 3, mb, S); accum =
    `pcfg.accum_for(shape.name)`, and microbatch i is every leaf's [i].

    Each microbatch's gradients are cast to float32 and summed in order,
    then divided by `accum`; then the optional int8 compression with
    error feedback, clipping to global norm 1, and AdamW at
    `cosine_schedule(base_lr, warmup, total_steps)` of the step before its
    increment. Metrics: ``loss`` (the microbatches' mean), ``grad_norm``
    (before clipping) and ``lr``, 0-d tensors. `state` is not changed.

    `grad_shardings`, a tree of DTensor placements like the params (the
    step builders' `launch/steps.py`), redistributes each microbatch's
    gradients to the parameters' placements before they are summed: a
    reduce-scatter into the FSDP accumulator instead of a full
    all-reduce, as the reference's sharding constraint gives.
    """
    lr_fn = adamw.cosine_schedule(base_lr, warmup, total_steps)
    accum = pcfg.accum_for(shape.name)
    grad_fn = value_and_grad(lambda p, mb: lm_loss(p, cfg, pcfg, mb)[0])

    def constrain_grads(grads):
        if grad_shardings is None:
            return grads
        return tree_map(lambda g, place: g if tuple(g.placements) == place
                        else g.redistribute(g.device_mesh, place),
                        grads, grad_shardings)

    def train_step(state: TrainState, batch: dict):
        params = state.params
        batch = batch_to_device(batch, tree_leaves(params)[0].device)
        grads, loss = None, None
        for i in range(accum):
            mb_loss, mb_grads = grad_fn(params,
                                        {k: v[i] for k, v in batch.items()})
            mb_grads = constrain_grads(mb_grads)
            if grads is None:
                grads = tree_map(lambda g: g.float(), mb_grads)
                loss = mb_loss
            else:
                grads = tree_map(lambda a, g: a + g.float(), grads, mb_grads)
                loss = loss + mb_loss
            del mb_grads  # before the next microbatch's backward
        if accum > 1:
            grads = tree_map(lambda g: g / accum, grads)
            loss = loss / accum

        err_buf = state.err_buf
        if pcfg.grad_compression and err_buf is not None:
            grads, err_buf = compress_decompress(grads, err_buf)
        grads, gnorm = adamw.clip_by_global_norm(grads, 1.0)
        lr = lr_fn(state.step)
        new_params, new_opt = adamw.adamw_update(
            grads, state.opt, params, lr, state_dtype=pcfg.opt_state_dtype)
        return (TrainState(params=new_params, opt=new_opt,
                           step=state.step + 1, err_buf=err_buf),
                {"loss": loss, "grad_norm": gnorm, "lr": lr})

    return train_step


# ---------------------------------------------------------------------------
# the RecSys filtering model
# ---------------------------------------------------------------------------
def init_recsys_train_state(params: Any, device=None) -> TrainState:
    """Optimizer state for a RecSys model's parameters on `device`
    (default `cuda`): the parameters (moved there if they are not), zero
    float32 AdamW moments and step 0."""
    params = to_device(params, resolve_device(device))
    return TrainState(params=params, opt=adamw.init_adamw_state(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=tree_leaves(params)[0].device))


def make_loss_step(loss_fn: Callable[[Any, dict], torch.Tensor], *,
                   lr: float = 3e-3, weight_decay: float = 0.0
                   ) -> Callable[[TrainState, dict],
                                 tuple[TrainState, torch.Tensor]]:
    """One AdamW step at a flat `lr` of ``loss_fn(params, batch) -> 0-d
    loss``: ``(state, batch) -> (state', loss)``. Batches are numpy
    (staged on the state's device) or tensors there already. `state` is
    not changed: `state'` holds new tensors only."""
    loss_and_grads = value_and_grad(loss_fn)

    def train_step(state: TrainState, batch: dict):
        device = tree_leaves(state.params)[0].device
        loss, grads = loss_and_grads(state.params,
                                     batch_to_device(batch, device))
        params, opt = adamw.adamw_update(grads, state.opt, state.params, lr,
                                         weight_decay=weight_decay)
        return TrainState(params=params, opt=opt,
                          step=state.step + 1), loss

    return train_step


def make_recsys_train_step(cfg: rs.YoutubeDNNConfig, *, lr: float = 3e-3,
                           weight_decay: float = 0.0
                           ) -> Callable[[TrainState, dict],
                                         tuple[TrainState, torch.Tensor]]:
    """One filtering-model gradient step: ``(state, batch) -> (state',
    loss)``, full-softmax `recsys.filtering_loss` under `make_loss_step`
    (the offline recipe of the reference's `benchmarks/accuracy_hr.py`).
    Batches come from `data.synthetic.movielens_batches`."""
    return make_loss_step(lambda p, b: rs.filtering_loss(p, cfg, b), lr=lr,
                          weight_decay=weight_decay)
