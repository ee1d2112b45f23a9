"""The RecSys filtering-model train step (mirrors the RecSys part of
`repro/distributed/training.py`): full-softmax `filtering_loss` and AdamW
at a flat learning rate, from a `TrainState`.

Offline pretraining and the online trainer (`serving/online.py`) run the
same step, so the model the trainer continues is the one the engine was
built from. The step is a plain function of tensors: the gradient comes
from `torch.autograd.grad` over the parameter dict's leaves
(`value_and_grad`, as `jax.value_and_grad` gives the reference's), and
the update is the reference's own AdamW rule (`optim/adamw.py`), out of
place. It never waits on the card: the loss comes back as a 0-d tensor
and the caller syncs when it reads it.

The LM step of the reference (`make_train_step`, `chunked_cross_entropy`,
`lm_loss`) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models import recsys as rs
from repro_torch.optim import adamw
from repro_torch.utils import resolve_device, to_device, tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: adamw.AdamWState
    step: torch.Tensor  # () int32


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
