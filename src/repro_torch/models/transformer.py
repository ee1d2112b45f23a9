"""Config-driven decoder LM: the dense family (llama3-405b, qwen3-8b with
qk-norm, qwen2.5-3b with qkv bias and tied embeddings, chatglm3-6b with
partial rotary), MoE (phi3.5-moe: 16 experts top-2; llama4-maverick: 128
experts top-1 with a shared expert, dense and MoE layers alternating),
SSM (mamba2-1.3b, SSD) and hybrid (zamba2-1.2b: a Mamba2 backbone with one
shared attention block before every `attn_every` layers and once before
the remainder, each invocation with its own KV cache), audio
(musicgen-large: a (B, K, S) codebook grid whose K embeddings are summed
at the input, the iMARS multi-table pooled lookup, and K output heads)
and VLM (qwen2-vl-72b: M-RoPE over (3, B, S) positions, and precomputed
patch embeddings scattered into the token embeddings at `vision_pos`;
the vision tower is a stub, as in the reference). The audio and VLM
models run the dense stack.

The port of `repro/models/transformer.py` for training and serving. Layer
params are stacked on a leading layer axis as in the reference; its
`jax.lax.scan` over layers is a Python loop that indexes the stacked
tensors. `forward(mode="train")` runs under autograd, each layer (each
dense + MoE pair, each hybrid group) checkpointed with `remat="block"`
(the reference's `jax.checkpoint` of its scan body); prefill and decode
run without grad. Decode writes the attention KV caches in place and
returns new recurrent (conv, ssm) states, leaving the caller's untouched.
The token embedding's gather has a deterministic backward
(`layers.gather_rows`), and the vision scatter is out of place, so
autograd keeps it.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import attention, init_attention
from repro_torch.models.layers import (
    gather_rows,
    init_mlp,
    init_rms_norm,
    mlp,
    normal,
    param_dtype,
    rms_norm,
)
from repro_torch.models.moe import init_moe, moe_layer
from repro_torch.utils import resolve_device

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


class ModelOutput(NamedTuple):
    hidden: torch.Tensor | None  # (B, S, D) final hidden
    logits: torch.Tensor | None  # (B, S_out, V) or (B, S_out, K, V)
    aux_loss: torch.Tensor
    caches: Any  # the family's cache tree (serve modes)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} ({cfg.name}): one of "
                         f"{FAMILIES}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_block(gen, cfg: ModelConfig, device, kind: str,
                lead: tuple) -> dict:
    """One block's params (stacked over `lead`): dense or moe (attention
    and an MLP or experts), or mamba."""
    dt, D = param_dtype(cfg), cfg.d_model
    p = {"norm1": init_rms_norm(D, dt, device, lead)}
    if kind == "mamba":
        p["ssm"] = ssm_mod.init_mamba2(gen, cfg, device, lead)
        return p
    p["norm2"] = init_rms_norm(D, dt, device, lead)
    p["attn"] = init_attention(gen, cfg, device, lead)
    if kind == "moe":
        p["moe"] = init_moe(gen, cfg, device, lead)
    else:
        p["mlp"] = init_mlp(gen, cfg, device, lead=lead)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights in the reference's layout and scales, drawn from
    `generator`, which must live on `device` (default `cuda`). Stacked
    weights are drawn a slab at a time, never as a float32 whole. On
    `meta` (generator None) the tree has every leaf's shape and dtype and
    no storage: the counterpart of `jax.eval_shape(init_params)`."""
    _check_family(cfg)
    device = resolve_device(device, allow_meta=True)
    if device.type != "meta" and generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, params on "
                         f"{device}")
    dt = param_dtype(cfg)
    V, D, L = cfg.padded_vocab, cfg.d_model, cfg.n_layers
    # the audio model has one table and one output head a codebook
    books = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    params = {"embed": normal(generator, books + (V, D), 0.02, dt, device)}
    if cfg.family in ("dense", "vlm", "audio"):
        params["layers"] = _init_block(generator, cfg, device, "dense", (L,))
    elif cfg.family == "moe" and cfg.moe_layer_step == 1:
        params["layers"] = _init_block(generator, cfg, device, "moe", (L,))
    elif cfg.family == "moe":  # alternating dense / moe pairs (llama4)
        if cfg.moe_layer_step != 2 or L % 2:
            raise ValueError(f"moe_layer_step {cfg.moe_layer_step} with "
                             f"{L} layers")
        params["layers"] = {
            kind: _init_block(generator, cfg, device, kind, (L // 2,))
            for kind in ("dense", "moe")}
    elif cfg.family == "ssm":
        params["layers"] = _init_block(generator, cfg, device, "mamba", (L,))
    else:  # hybrid
        groups, rem = divmod(L, cfg.attn_every)
        params["mamba_layers"] = _init_block(
            generator, cfg, device, "mamba", (groups * cfg.attn_every,))
        if rem:
            params["extra_mamba"] = _init_block(generator, cfg, device,
                                                "mamba", (rem,))
        params["shared_attn"] = _init_block(generator, cfg, device, "dense",
                                            ())
    params["final_norm"] = init_rms_norm(D, dt, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(generator, books + (D, V), D**-0.5, dt,
                                   device)
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _attn_mlp_block(p, x, cfg, positions, *, cache=None, cache_index=None,
                    make_cache=False, cache_len=None, cache_dtype="bfloat16",
                    attn_impl="blocked", use_moe=False):
    """Returns (x, aux loss or None without experts, new cache)."""
    x = constrain(x, ("act_batch", "act_seq", None))
    h, new_cache = attention(
        p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, positions,
        cache=cache, cache_index=cache_index, make_cache=make_cache,
        cache_len=cache_len, cache_dtype=cache_dtype, attn_impl=attn_impl)
    # the attention's output projection leaves its sum pending: resolved
    # before the residual add (which would otherwise split `x` into
    # per-rank parts of the sum), else DTensor keeps it pending through
    # the MLP by gathering the MLP's column-sharded weights whole
    x = x + constrain(h, ("act_batch", "act_seq", None))
    if use_moe:
        y, aux = moe_layer(p["moe"], rms_norm(x, p["norm2"], cfg.norm_eps),
                           cfg)
        return x + constrain(y, ("act_batch", "act_seq", None)), aux, \
            new_cache
    # `h` lives until the block returns: freeing it earlier fragments the
    # caching allocator enough to run full-width training out of memory
    # (`chip_smoke.py` phase I peaks at 78.7 of the card's 85 GB)
    x = x + mlp(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg)
    return constrain(x, ("act_batch", "act_seq", None)), None, new_cache


def _mamba_block(p, x, cfg, state=None):
    """Returns (x, (conv_state, ssm_state)); decode iff `state` is given."""
    conv_s, ssm_s = (None, None) if state is None else state
    x = constrain(x, ("act_batch", "act_seq", None))
    h, states = ssm_mod.mamba2_block(
        p["ssm"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg,
        conv_state=conv_s, ssm_state=ssm_s, decode=state is not None)
    return x + h, states


def _index(tree, i: int):
    """Layer `i` of stacked params, a KVCacheView or a state tuple
    (views, no copy); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_index(t, i) for t in tree)) \
            if hasattr(tree, "_fields") else tuple(_index(t, i) for t in tree)
    return tree[i]


def _stack(items: list):
    """Per-layer KVCacheViews or state tuples stacked on a new axis 0."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    if isinstance(first, tuple):
        parts = [_stack(list(ts)) for ts in zip(*items)]
        return type(first)(*parts) if hasattr(first, "_fields") \
            else tuple(parts)
    return torch.stack(items)


# ---------------------------------------------------------------------------
# embedding in / out
# ---------------------------------------------------------------------------
def embed_tokens(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """(B, S, D): the tokens' rows; for the audio model the sum of the K
    codebooks' rows of a (B, K, S) grid; for the VLM, with
    `vision_embeds` (B, n_vis, D) given, those (cast to the model dtype)
    in place of the rows at `vision_pos` (B, n_vis), written out of
    place. Slots must not repeat within a row: the reference's scatter
    gives a repeated slot no defined order."""
    _check_family(cfg)
    tokens = batch["tokens"].long()
    if cfg.family == "audio":
        return _audio_embed(params, tokens)
    # a vocab-sharded table's rows come back as a pending sum: resolved
    # here, as the residual is
    x = constrain(gather_rows(params["embed"], tokens),  # (B, S, D)
                  ("act_batch", "act_seq", None))
    if cfg.family == "vlm" and "vision_embeds" in batch:
        vis = batch["vision_embeds"].to(x.dtype)
        pos = batch["vision_pos"].long()
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        x = x.index_put((rows.expand_as(pos), pos), vis)
    return x


def _audio_embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, K, S), embed (K, V, D): each codebook's gather, summed
    over K."""
    per = torch.stack([gather_rows(t, tokens[:, k]) for k, t in
                       enumerate(params["embed"].unbind(0))])  # (K, B, S, D)
    return constrain(per.sum(0), ("act_batch", "act_seq", None))


def unembed(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h (B, S, D) -> logits (B, S, padded_V), or (B, S, K, padded_V) for
    the audio model's K heads; the vocab-padding tail (ids >= vocab_size)
    is -1e30 so argmax never emits a padded id."""
    if cfg.family == "audio":
        logits = torch.einsum("bsd,kdv->bskv", h, params["lm_head"])
    else:
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = constrain(h @ w, ("act_batch", None, "act_vocab"))
    if cfg.padded_vocab != cfg.vocab_size:
        ids = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = logits.masked_fill(ids >= cfg.vocab_size, -1e30)
    return logits


def default_positions(cfg: ModelConfig, batch: dict, B: int, S: int,
                      offset=0) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    dev = batch["tokens"].device
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None, :] + int(
        offset)
    pos = pos.expand(B, S)
    if cfg.rope_style == "mrope":  # every component the same index
        return pos[None].expand(3, B, S)
    return pos


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def forward(
    params: dict,
    cfg: ModelConfig,
    batch: dict,
    *,
    mode: str = "train",  # train | prefill | decode
    caches: Any = None,  # the family's cache tree (decode)
    cache_index=None,
    cache_len: int | None = None,
    cache_dtype: str = "bfloat16",
    remat: str = "none",  # train: none | block (checkpoint each layer)
    attn_impl: str = "blocked",
    logits_mode: str = "auto",  # auto | none | last | all
) -> ModelOutput:
    """The reference's `forward` for every family. Train mode records
    autograd (the blocked attention's custom backward; `remat="block"`
    recomputes each layer's activations in the backward); prefill and
    decode run without grad. Prefill returns the family's cache tree
    (`serving/kv_cache.py`); decode writes the KV caches of `caches` in
    place and returns them, with new recurrent states. `aux_loss` is the
    experts' load-balancing loss summed over layers (0 without experts).
    `batch` values may be numpy arrays or tensors and move to the params'
    device."""
    _check_family(cfg)
    if remat not in ("none", "block"):
        raise ValueError(f"remat {remat!r}: none or block")
    grad = contextlib.nullcontext() if mode == "train" else torch.no_grad()
    with grad:
        return _forward(params, cfg, batch, mode, caches, cache_index,
                        cache_len, cache_dtype, remat, attn_impl,
                        logits_mode)


def _forward(params, cfg, batch, mode, caches, cache_index, cache_len,
             cache_dtype, remat, attn_impl, logits_mode) -> ModelOutput:
    dev = params["embed"].device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    tokens = batch["tokens"]
    B, S = tokens.shape[0], tokens.shape[-1]  # audio: (B, K, S)
    x = embed_tokens(params, cfg, batch)
    offset = cache_index if mode == "decode" else 0
    positions = default_positions(cfg, batch, B, S, offset=offset)

    ctx = _Ctx(cfg, positions, mode, cache_index, cache_len, cache_dtype,
               remat, attn_impl)
    aux = None
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        x, aux, caches = _transformer_stack(params, ctx, x, caches)
    elif cfg.family == "ssm":
        x, caches = _mamba_stack(params["layers"], cfg.n_layers, ctx, x,
                                 caches)
    else:
        x, caches = _hybrid_stack(params, ctx, x, caches)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)

    if logits_mode == "auto":
        logits_mode = {"train": "none", "prefill": "last",
                       "decode": "all"}[mode]
    logits = None
    if logits_mode == "last":
        logits = unembed(params, cfg, x[:, -1:])
    elif logits_mode == "all":
        logits = unembed(params, cfg, x)
    if aux is None:
        aux = torch.zeros((), device=dev)
    return ModelOutput(hidden=x, logits=logits, aux_loss=aux, caches=caches)


class _Ctx(NamedTuple):
    """What every layer of one forward call shares."""

    cfg: ModelConfig
    positions: torch.Tensor
    mode: str
    cache_index: Any
    cache_len: int | None
    cache_dtype: str
    remat: str
    attn_impl: str

    def attn_block(self, p, x, cache, use_moe=False):
        return _attn_mlp_block(
            p, x, self.cfg, self.positions, cache=cache,
            cache_index=self.cache_index,
            make_cache=self.mode == "prefill", cache_len=self.cache_len,
            cache_dtype=self.cache_dtype, attn_impl=self.attn_impl,
            use_moe=use_moe)

    def layer(self, fn, x, *args):
        """`fn(x, *args)`, checkpointed in train mode under remat."""
        if self.mode == "train" and self.remat == "block":
            return checkpoint(fn, x, *args, use_reentrant=False)
        return fn(x, *args)


def _parts(cfg: ModelConfig) -> tuple:
    """The (key in a layer's params, experts?) blocks of one step of the
    layer loop: one block, or llama4's dense + MoE pair."""
    if cfg.family == "moe" and cfg.moe_layer_step == 2:
        return (("dense", False), ("moe", True))
    return ((None, cfg.family == "moe"),)


def _transformer_stack(params, ctx: _Ctx, x, caches):
    """The dense (also the audio and VLM models') and MoE stacks: prefill
    stacks the new caches (a dict of two stacks for llama4's pairs),
    decode writes into `caches` in place, and train mode checkpoints each
    step under `remat="block"`. The aux loss is the experts' sum, None
    without experts."""
    cfg, parts = ctx.cfg, _parts(ctx.cfg)
    n_steps = cfg.n_layers // len(parts)
    decode = ctx.mode == "decode"

    def step(x, p, cache):
        aux, new = None, {}
        for key, use_moe in parts:
            x, a, new[key] = ctx.attn_block(
                p if key is None else p[key], x,
                cache if key is None or cache is None else cache[key],
                use_moe)
            aux = _add(aux, a)
        return x, aux, (new[None] if None in new else new)

    aux, made = None, []
    for i in range(n_steps):
        p = _index(params["layers"], i)
        if ctx.mode == "train":
            x, a = ctx.layer(lambda x, p: step(x, p, None)[:2], x, p)
        else:
            x, a, new_cache = step(x, p, _index(caches, i) if decode
                                   else None)
            made.append(new_cache)
        aux = _add(aux, a)
    if ctx.mode == "prefill":
        return x, aux, _stack(made)
    return x, aux, (caches if decode else None)


def _add(total, a):
    """An aux-loss sum in the reference's order; None is no expert yet."""
    return a if total is None else total if a is None else total + a


def _mamba_stack(layers, n: int, ctx: _Ctx, x, states):
    """`n` stacked Mamba2 layers; returns (x, (conv, ssm) stacked over
    the layers), new tensors (None in train mode)."""
    made = []
    for i in range(n):
        p = _index(layers, i)
        if ctx.mode == "train":
            x = ctx.layer(lambda x, p: _mamba_block(p, x, ctx.cfg)[0], x, p)
        else:
            x, new = _mamba_block(p, x, ctx.cfg, _index(states, i)
                                  if ctx.mode == "decode" else None)
            made.append(new)
    return x, (None if ctx.mode == "train" else _stack(made))


def _hybrid_stack(params, ctx: _Ctx, x, caches):
    """Zamba2: the shared attention block before every group of
    `attn_every` Mamba2 layers and once before the remainder, each
    invocation with its own KV cache. The cache tree is (attention caches
    stacked over groups, (conv, ssm) stacked over (groups, attn_every),
    rem_state) with rem_state = (the remainder's attention cache, (conv,
    ssm) stacked over its layers), or None without a remainder. Train
    mode checkpoints each group under `remat="block"`."""
    cfg = ctx.cfg
    groups, rem = divmod(cfg.n_layers, cfg.attn_every)
    shared = params["shared_attn"]
    decode = ctx.mode == "decode"
    attn_caches, m_states, rem_state = caches if decode else (None,) * 3

    inner = ctx._replace(remat="none")  # a group is checkpointed whole

    def group(x, shared, layers, n, attn_cache, states):
        x, _, new_cache = inner.attn_block(shared, x, attn_cache)
        x, new_states = _mamba_stack(layers, n, inner, x, states)
        return x, new_cache, new_states

    made_attn, made_states = [], []
    for g in range(groups):
        lo = g * cfg.attn_every
        layers = _slice(params["mamba_layers"], lo, lo + cfg.attn_every)
        if ctx.mode == "train":
            x = ctx.layer(lambda x, s, ly: group(x, s, ly, cfg.attn_every,
                                                 None, None)[0],
                          x, shared, layers)
            continue
        x, new_cache, new_states = group(
            x, shared, layers, cfg.attn_every, _index(attn_caches, g),
            _index(m_states, g))
        made_attn.append(new_cache)
        made_states.append(new_states)

    new_rem = None
    if rem:
        rem_attn, rem_m = rem_state if decode else (None, None)
        x, new_rem_attn, new_rem_m = group(x, shared, params["extra_mamba"],
                                           rem, rem_attn, rem_m)
        new_rem = (new_rem_attn, new_rem_m)
    if ctx.mode == "train":
        return x, None
    if decode:
        return x, (attn_caches, _stack(made_states), new_rem)
    return x, (_stack(made_attn), _stack(made_states), new_rem)


def _slice(tree, lo: int, hi: int):
    """Layers lo:hi of stacked params (views)."""
    if isinstance(tree, dict):
        return {k: _slice(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]
