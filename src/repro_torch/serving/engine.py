"""LM prefill / decode steps and a batched greedy generation engine.

The port of `repro/serving/engine.py` for every family. There is no
`jax.jit`: each step runs eagerly on the params' device. Decode updates
the KV caches in place (see `models/attention.py`) and returns new
recurrent states (`serving/kv_cache.py`); the SSM and hybrid families'
states come out of the prefill's own scan.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


def prefill(params, cfg: ModelConfig, batch: dict, *, cache_len: int,
            cache_dtype: str = "bfloat16", remat: str = "none",
            attn_impl: str = "blocked") -> tf.ModelOutput:
    """Process a prompt batch; returns last-token logits + the filled
    cache tree (KV caches and recurrent states)."""
    return tf.forward(params, cfg, batch, mode="prefill",
                      cache_len=cache_len, cache_dtype=cache_dtype,
                      remat=remat, attn_impl=attn_impl, logits_mode="last")


def decode_step(params, cfg: ModelConfig, batch: dict, caches: Any,
                cache_index, *, attn_impl: str = "blocked"
                ) -> tf.ModelOutput:
    """One token per sequence against an existing cache tree: KV caches
    written in place at `cache_index`, new recurrent states returned."""
    return tf.forward(params, cfg, batch, mode="decode", caches=caches,
                      cache_index=cache_index, attn_impl=attn_impl,
                      logits_mode="all")


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, n_generated), audio (B, K, n_generated); int32


class LMServingEngine:
    """Synchronous batched engine: prefill once, greedy-decode n steps.

    The argmax runs on the card; the chosen tokens come back to the host
    once per step, as in the reference. The audio model takes and makes a
    (B, K) token grid a step; the prompt's other inputs (the VLM's vision
    embeddings, slots and positions) go to the prefill only, and decode
    positions are the cache index.
    """

    def __init__(self, params, cfg: ModelConfig, *, batch: int,
                 cache_len: int, cache_dtype: str = "bfloat16"):
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.cache_len = cache_len
        self.cache_dtype = cache_dtype

    def generate(self, prompt_batch: dict, n_steps: int) -> GenerationResult:
        cfg = self.cfg
        prompt_len = prompt_batch["tokens"].shape[-1]
        out = prefill(self.params, cfg, prompt_batch,
                      cache_len=self.cache_len, cache_dtype=self.cache_dtype)
        caches = out.caches
        tok = out.logits[:, -1].argmax(-1)  # greedy; audio (B, K)
        toks = [tok.to(torch.int32).cpu().numpy()]
        index = prompt_len
        for _ in range(n_steps - 1):
            out = decode_step(self.params, cfg, {"tokens": tok[..., None]},
                              caches, index)
            caches = out.caches
            tok = out.logits[:, -1].argmax(-1)
            toks.append(tok.to(torch.int32).cpu().numpy())
            index += 1
        return GenerationResult(tokens=np.stack(toks, axis=-1))
