"""Step builders (the port of `repro/launch/steps.py`): per (arch x shape x
mesh), the step function over DTensors, its abstract inputs (`meta`
tensors: shapes and dtypes, no storage) and their placements.

This is where the mesh meets the model: kv_repeat is derived from the model
axis, `ShardingRules` are made per shape kind, and every input gets its
partition spec and DTensor placements. A built step's `fn` takes its
state (or parameters), batch and caches as DTensors on those placements
(`BuiltStep.shard`) and returns what the reference's jitted function
returns: the new state and cache trees as DTensors on the reference's
`out_shardings`, the metrics and logits whole (replicated) as plain
tensors. Inside, the rules and the mesh are active (`use_rules`), so the
model's `constrain` points redistribute its activations, and plain
tensors made mid-step count as replicated (DTensor's
`implicit_replication`). The decode step writes its KV caches in place,
as the port's decode does; the reference donates that buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import (
    SHAPES,
    ArchBundle,
    ModelConfig,
    ParallelConfig,
    ShapeConfig,
)
from repro_torch.distributed import training as tr
from repro_torch.distributed.sharding import (
    P,
    ShardingRules,
    compute_mesh,
    full,
    map_tree,
    named_shardings,
    param_partition_specs,
    shard_tree,
    to_placements,
    tree_placements,
    use_rules,
)
from repro_torch.launch.mesh import data_axes_of, mesh_shape
from repro_torch.models import transformer as tf
from repro_torch.models.attention import KVCacheView
from repro_torch.optim.adamw import AdamWState, QuantState
from repro_torch.serving import engine as serve_engine
from repro_torch.serving.kv_cache import init_cache


# ---------------------------------------------------------------------------
# mesh adaptation
# ---------------------------------------------------------------------------
def adapt_model_to_mesh(cfg: ModelConfig, mesh) -> ModelConfig:
    """Set kv_repeat so rep_kv_heads shards exactly over the model axis
    (only when the resulting grouping still divides n_heads)."""
    model_size = mesh_shape(mesh)["model"]
    if (cfg.n_kv_heads and cfg.n_kv_heads < model_size
            and model_size % cfg.n_kv_heads == 0):
        r = model_size // cfg.n_kv_heads
        if cfg.n_heads % (cfg.n_kv_heads * r) == 0:
            return cfg.with_(kv_repeat=r)
    return cfg


def heads_shardable(cfg: ModelConfig, mesh) -> bool:
    if not cfg.n_heads:
        return True
    return cfg.rep_kv_heads % mesh_shape(mesh)["model"] == 0


def make_rules(pcfg: ParallelConfig, mesh, shape: ShapeConfig,
               kind: str, shard_heads: bool = True) -> ShardingRules:
    data_axes = data_axes_of(mesh)
    long_ctx = shape.kind == "decode" and shape.global_batch < _data_size(mesh)
    if kind == "train":
        return ShardingRules(
            data_axes=data_axes, fsdp=pcfg.fsdp, seq_shard=pcfg.seq_shard,
            shard_heads=shard_heads, moe_ff_fsdp=pcfg.moe_shard_ff)
    # serving; unshardable heads -> parallelize prefill over the sequence
    return ShardingRules(
        data_axes=data_axes,
        fsdp=(pcfg.serve_weight_sharding == "2d"),
        seq_shard=(not shard_heads) and shape.kind == "prefill",
        kv_seq_data=long_ctx,
        batch_data=not long_ctx,
        shard_heads=shard_heads,
        moe_ff_fsdp=pcfg.moe_shard_ff,
    )


def _data_size(mesh) -> int:
    shp = mesh_shape(mesh)
    return shp["data"] * shp.get("pod", 1)


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------
def opt_state_specs(params, opt: AdamWState, rules: ShardingRules):
    pspecs = param_partition_specs(params, rules)

    def moment_specs(moment):
        # an int8 moment's scales: the param's spec with the last dim whole
        return map_tree(lambda _, spec, m: QuantState(
            values=spec, scales=P(*(tuple(spec)[:-1] + (None,))))
            if isinstance(m, QuantState) else spec, pspecs, moment)

    return AdamWState(mu=moment_specs(opt.mu), nu=moment_specs(opt.nu),
                      count=P())


def train_state_specs(state: tr.TrainState, rules: ShardingRules):
    pspecs = param_partition_specs(state.params, rules)
    return tr.TrainState(
        params=pspecs,
        opt=opt_state_specs(state.params, state.opt, rules),
        step=P(),
        err_buf=None if state.err_buf is None else pspecs,
    )


def cache_partition_specs(cfg: ModelConfig, rules: ShardingRules):
    """Specs matching `serving.kv_cache.init_cache`'s tree (before the
    bf16 caches' scale leaves are pruned: `_prune`)."""
    batch_ax = rules.data_axes if rules.batch_data else None
    seq_ax = rules.data_axes if rules.kv_seq_data else None
    if seq_ax is None and not rules.shard_heads:
        # unshardable heads: flash-decode layout (cache seq over model)
        seq_ax = rules.model_axis
    kv = lambda: _kv_specs(batch_ax, seq_ax, rules.model_axis,  # noqa: E731
                           rules.shard_heads)
    if cfg.family in ("dense", "vlm", "audio"):
        return kv()
    if cfg.family == "moe":
        if cfg.moe_layer_step == 1:
            return kv()
        return {"dense": kv(), "moe": kv()}
    ssm_specs = (
        P(None, batch_ax, None, rules.model_axis),  # conv (L,B,K-1,cd)
        P(None, batch_ax, rules.model_axis, None, None),  # ssm (L,B,H,P,N)
    )
    if cfg.family == "ssm":
        return ssm_specs
    if cfg.family == "hybrid":
        rem = cfg.n_layers % cfg.attn_every
        g_ssm = (
            P(None, None, batch_ax, None, rules.model_axis),
            P(None, None, batch_ax, rules.model_axis, None, None),
        )
        rem_state = None
        if rem:
            rem_attn = _kv_specs(batch_ax, seq_ax, rules.model_axis,
                                 rules.shard_heads, stacked=False)
            rem_state = (rem_attn, ssm_specs)
        return (kv(), g_ssm, rem_state)
    raise ValueError(cfg.family)


def _kv_specs(batch_ax, seq_ax, model_axis, shard_heads=True, stacked=True):
    lead = (None,) if stacked else ()
    head_ax = model_axis if shard_heads else None
    arr = P(*lead, batch_ax, head_ax, seq_ax, None)
    return KVCacheView(k=arr, v=arr, k_scale=arr, v_scale=arr)


def _prune(specs, cache):
    """Align a spec tree with the cache tree: a None child of the cache
    (a bf16 cache's scales, no remainder state) is None in the specs."""
    return map_tree(lambda _, leaf, spec: spec, cache, specs)


# ---------------------------------------------------------------------------
# batch specs
# ---------------------------------------------------------------------------
def _abstract(shape: tuple, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_abstract(cfg: ModelConfig, pcfg: ParallelConfig,
                         shape: ShapeConfig, mesh):
    accum = pcfg.accum_for(shape.name)
    gb, S = shape.global_batch, shape.seq_len
    assert gb % accum == 0
    mb = gb // accum
    dsz = _data_size(mesh)
    assert mb % dsz == 0, (
        f"{cfg.name}: microbatch {mb} not divisible by data size {dsz}")
    data = data_axes_of(mesh)
    if cfg.family == "audio":
        tok_shape = (accum, mb, cfg.n_codebooks, S)
        spec = P(None, data, None, None)
    else:
        tok_shape = (accum, mb, S)
        spec = P(None, data, None)
    batch = {"tokens": _abstract(tok_shape), "labels": _abstract(tok_shape)}
    specs = {"tokens": spec, "labels": spec}
    if cfg.family == "vlm":
        nv = cfg.vision_tokens
        batch["vision_embeds"] = _abstract((accum, mb, nv, cfg.d_model),
                                           torch.bfloat16)
        batch["vision_pos"] = _abstract((accum, mb, nv))
        specs["vision_embeds"] = P(None, data, None, None)
        specs["vision_pos"] = P(None, data, None)
        # M-RoPE positions from the frontend stub; the accum axis leads
        batch["positions"] = _abstract((accum, 3, mb, S))
        specs["positions"] = P(None, None, data, None)
    return batch, specs


def serve_batch_abstract(cfg: ModelConfig, shape: ShapeConfig, mesh,
                         rules: ShardingRules, kind: str):
    B = shape.global_batch
    S = shape.seq_len if kind == "prefill" else 1
    batch_ax = rules.data_axes if rules.batch_data else None
    if cfg.family == "audio":
        tok = _abstract((B, cfg.n_codebooks, S))
        spec = P(batch_ax, None, None)
    else:
        tok = _abstract((B, S))
        spec = P(batch_ax, None)
    batch = {"tokens": tok}
    specs = {"tokens": spec}
    if cfg.family == "vlm" and kind == "prefill":
        nv = cfg.vision_tokens
        batch["vision_embeds"] = _abstract((B, nv, cfg.d_model),
                                           torch.bfloat16)
        batch["vision_pos"] = _abstract((B, nv))
        specs["vision_embeds"] = P(batch_ax, None, None)
        specs["vision_pos"] = P(batch_ax, None)
    if cfg.family == "vlm":
        batch["positions"] = _abstract((3, B, S))
        specs["positions"] = P(None, batch_ax, None)
    return batch, specs


# ---------------------------------------------------------------------------
# placing trees
# ---------------------------------------------------------------------------
def redistribute_tree(tree, place_tree, mesh):
    """Every tensor leaf of `tree` on the placements at the same place in
    `place_tree`: a DTensor is redistributed, a plain tensor (made whole
    on every rank) kept as this rank's block."""
    return map_tree(lambda _, x, place: to_placements(x, mesh, place), tree,
                    place_tree)


def full_tree(tree):
    """`full` over every leaf of a tree of any of the port's nodes."""
    return map_tree(lambda _, x: full(x), tree)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BuiltStep:
    """A step for one (arch x shape x mesh): `fn` over DTensors,
    `abstract_args` (`meta` trees of its inputs), the rules, the
    mesh-adapted config, per input its spec tree (`specs`: the
    reference's in_shardings) and so its DTensor placements
    (`placements`), and per output its spec tree (`out_specs`; None where
    it comes back whole)."""

    fn: Callable
    abstract_args: tuple
    rules: ShardingRules
    cfg: ModelConfig
    specs: tuple
    mesh: Any
    out_specs: tuple = ()  # the reference's out_shardings (None: whole)

    @property
    def placements(self) -> tuple:
        """Per input, its spec tree as a tree of placements tuples."""
        return tuple(tree_placements(s, self.mesh) for s in self.specs)

    def shardings(self, i: int):
        """Input `i`'s `NamedSharding` tree (a checkpoint restores onto
        it: `Checkpointer.restore_latest(template, shardings)`)."""
        return named_shardings(self.specs[i], self.mesh)

    def shard(self, i: int, tree):
        """Input `i` (the same whole tree of tensors on every rank: a
        seeded state, parameters, a batch or caches) placed as the step
        takes it; a dim its spec's axes do not divide raises, naming the
        arch and leaf."""
        return shard_tree(tree, self.specs[i], self.mesh,
                          what=f"{self.cfg.name}: ")


def build_train_step(bundle: ArchBundle, shape: ShapeConfig, mesh
                     ) -> BuiltStep:
    """``fn(state, batch) -> (state', metrics)``: the port's
    `make_train_step` with each microbatch's gradients redistributed to
    the parameters' placements (the reference's `grad_shardings`), the
    new state on the state's placements."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = adapt_model_to_mesh(bundle.model, mesh)
    cmesh = compute_mesh(mesh)
    pcfg = bundle.parallel
    rules = make_rules(pcfg, mesh, shape, "train",
                       shard_heads=heads_shardable(cfg, mesh))
    state_abs = tr.init_train_state(cfg, pcfg, None, device="meta")
    batch_abs, batch_specs = train_batch_abstract(cfg, pcfg, shape, mesh)
    state_specs = train_state_specs(state_abs, rules)
    state_place = tree_placements(state_specs, cmesh)
    step_fn = tr.make_train_step(cfg, pcfg, shape,
                                 grad_shardings=state_place.params)

    def fn(state, batch):
        with use_rules(rules), implicit_replication():
            new_state, metrics = step_fn(state, batch)
            new_state = redistribute_tree(new_state, state_place, cmesh)
            return new_state, {k: full(v) for k, v in metrics.items()}

    return BuiltStep(fn=fn, abstract_args=(state_abs, batch_abs),
                     rules=rules, cfg=cfg, specs=(state_specs, batch_specs),
                     mesh=cmesh, out_specs=(state_specs, None))


def params_abstract(cfg: ModelConfig):
    """The parameter tree on `meta` (`jax.eval_shape` of init_params)."""
    return tf.init_params(cfg, None, device="meta")


def build_prefill_step(bundle: ArchBundle, shape: ShapeConfig, mesh
                       ) -> BuiltStep:
    """``fn(params, batch) -> (last-token logits, caches)``."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = adapt_model_to_mesh(bundle.model, mesh)
    cmesh = compute_mesh(mesh)
    pcfg = bundle.parallel
    rules = make_rules(pcfg, mesh, shape, "serve",
                       shard_heads=heads_shardable(cfg, mesh))
    cache_dtype = pcfg.kv_cache_dtype
    params_abs = params_abstract(cfg)
    pspecs = param_partition_specs(params_abs, rules)
    batch_abs, batch_specs = serve_batch_abstract(cfg, shape, mesh, rules,
                                                  "prefill")
    cache_abs = init_cache(cfg, shape.global_batch, shape.seq_len,
                           cache_dtype, device="meta")
    cache_specs = _prune(cache_partition_specs(cfg, rules), cache_abs)
    cache_place = tree_placements(cache_specs, cmesh)

    def fn(params, batch):
        with use_rules(rules), implicit_replication():
            out = serve_engine.prefill(params, cfg, batch,
                                       cache_len=shape.seq_len,
                                       cache_dtype=cache_dtype,
                                       remat=pcfg.remat)
            return full(out.logits), redistribute_tree(out.caches,
                                                       cache_place, cmesh)

    return BuiltStep(fn=fn, abstract_args=(params_abs, batch_abs),
                     rules=rules, cfg=cfg, specs=(pspecs, batch_specs),
                     mesh=cmesh, out_specs=(None, cache_specs))


def build_decode_step(bundle: ArchBundle, shape: ShapeConfig, mesh
                      ) -> BuiltStep:
    """``fn(params, batch, caches, index) -> (logits, caches)``: one
    token a sequence; the KV caches are written in place."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = adapt_model_to_mesh(bundle.model, mesh)
    cmesh = compute_mesh(mesh)
    pcfg = bundle.parallel
    rules = make_rules(pcfg, mesh, shape, "serve",
                       shard_heads=heads_shardable(cfg, mesh))
    cache_dtype = pcfg.kv_cache_dtype
    params_abs = params_abstract(cfg)
    pspecs = param_partition_specs(params_abs, rules)
    batch_abs, batch_specs = serve_batch_abstract(cfg, shape, mesh, rules,
                                                  "decode")
    cache_abs = init_cache(cfg, shape.global_batch, shape.seq_len,
                           cache_dtype, device="meta")
    cache_specs = _prune(cache_partition_specs(cfg, rules), cache_abs)
    cache_place = tree_placements(cache_specs, cmesh)
    idx_abs = _abstract(())

    def fn(params, batch, caches, index):
        with use_rules(rules), implicit_replication():
            out = serve_engine.decode_step(params, cfg, batch, caches,
                                           int(full(torch.as_tensor(index))))
            return full(out.logits), redistribute_tree(out.caches,
                                                       cache_place, cmesh)

    return BuiltStep(
        fn=fn, abstract_args=(params_abs, batch_abs, cache_abs, idx_abs),
        rules=rules, cfg=cfg, specs=(pspecs, batch_specs, cache_specs, P()),
        mesh=cmesh, out_specs=(None, cache_specs))


def build_step(bundle: ArchBundle, shape_name: str, mesh) -> BuiltStep:
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_step(bundle, shape, mesh)
    if shape.kind == "prefill":
        return build_prefill_step(bundle, shape, mesh)
    return build_decode_step(bundle, shape, mesh)
