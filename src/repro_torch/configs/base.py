"""Config dataclasses of the LM side: architecture, parallelism plan,
train / serve shapes, bundle.

A copy of `repro/configs/base.py` (the port imports nothing of `repro`).
Every `ModelConfig` field is kept, so a config carries across unchanged;
fields of families the port does not serve yet (moe, ssm, hybrid, audio,
vlm) are only read by `param_count_dense` and `active_param_count`.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    # attention variants
    rope_theta: float = 1e4
    rope_fraction: float = 1.0  # chatglm3: 0.5 (2d/partial rotary)
    rope_style: str = "standard"  # standard | mrope
    mrope_sections: tuple = ()  # qwen2-vl: (t, h, w) half-dim split
    qk_norm: bool = False  # qwen3
    qkv_bias: bool = False  # qwen2.5 / qwen2-vl
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "swiglu"  # swiglu | gelu
    # moe
    n_experts: int = 0
    moe_top_k: int = 0
    moe_layer_step: int = 1
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # ssm (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    # hybrid (zamba2): shared attention block every k mamba layers
    attn_every: int = 0
    # audio (musicgen)
    n_codebooks: int = 1
    # vlm (qwen2-vl)
    vision_tokens: int = 0
    # numerics
    dtype: str = "bfloat16"
    # embedding tables padded to a multiple; the padded logit tail is
    # masked in unembed
    vocab_pad_multiple: int = 128
    # kv heads repeated to n_kv_heads * kv_repeat contiguous heads
    kv_repeat: int = 1
    # a layout hint of the reference's sharded path (no effect here)
    opt_kv_layout: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def d_inner(self) -> int:  # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rep_kv_heads(self) -> int:
        """KV heads after repetition (`kv_repeat`)."""
        return self.n_kv_heads * self.kv_repeat

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How an arch maps onto devices. The port reads `kv_cache_dtype`
    (serving) and `remat`, `opt_state_dtype`, `grad_accum`, `logit_chunk`
    and `grad_compression` (the LM train step)."""

    fsdp: bool = False
    seq_shard: bool = False
    serve_weight_sharding: str = "tp"  # "tp" | "2d"
    remat: str = "block"  # none | block
    kv_cache_dtype: str = "bfloat16"  # "int8" = the paper's ET quantization
    opt_state_dtype: str = "float32"
    grad_accum: Mapping[str, int] = dataclasses.field(
        default_factory=lambda: {"train_4k": 1}
    )
    logit_chunk: int = 0
    grad_compression: bool = False
    moe_shard_ff: bool = False

    def accum_for(self, shape_name: str) -> int:
        return dict(self.grad_accum).get(shape_name, 1)

    def with_(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchBundle:
    model: ModelConfig
    parallel: ParallelConfig
    # shapes this arch skips (with reasons)
    skip_shapes: Mapping[str, str] = dataclasses.field(default_factory=dict)


def param_count_dense(cfg: ModelConfig) -> int:
    """Approximate parameter count (embeddings + layers)."""
    d, v = cfg.d_model, cfg.vocab_size
    n = v * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family in ("ssm",):
        return n + cfg.n_layers * _mamba_layer_params(cfg)
    if cfg.family == "hybrid":
        per = _mamba_layer_params(cfg)
        attn = _attn_params(cfg) + _mlp_params(cfg)
        return n + cfg.n_layers * per + attn  # attn block is shared
    per = _attn_params(cfg)
    if cfg.n_experts:
        moe_layers = cfg.n_layers // cfg.moe_layer_step
        dense_layers = cfg.n_layers - moe_layers
        per_moe = cfg.n_experts * _mlp_params(cfg) + cfg.d_model * cfg.n_experts
        per_moe += cfg.n_shared_experts * _mlp_params(cfg)
        return (n + cfg.n_layers * per + dense_layers * _mlp_params(cfg)
                + moe_layers * per_moe)
    if cfg.family == "audio":
        n = cfg.n_codebooks * v * d * 2
    return n + cfg.n_layers * (per + _mlp_params(cfg))


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top_k experts only), for 6 N_active D."""
    if not cfg.n_experts:
        return param_count_dense(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    n = v * d * 2
    moe_layers = cfg.n_layers // cfg.moe_layer_step
    dense_layers = cfg.n_layers - moe_layers
    per_moe_active = (cfg.moe_top_k + cfg.n_shared_experts) * _mlp_params(cfg)
    return (n + cfg.n_layers * _attn_params(cfg)
            + dense_layers * _mlp_params(cfg) + moe_layers * per_moe_active)


def _attn_params(cfg: ModelConfig) -> int:
    d, hd = cfg.d_model, cfg.head_dim
    if not cfg.n_heads:
        return 0
    return d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2) + 2 * d


def _mlp_params(cfg: ModelConfig) -> int:
    mult = 3 if cfg.act == "swiglu" else 2
    return mult * cfg.d_model * cfg.d_ff


def _mamba_layer_params(cfg: ModelConfig) -> int:
    d, di = cfg.d_model, cfg.d_inner
    conv_dim = di + 2 * cfg.ssm_ngroups * cfg.ssm_state
    in_proj = d * (2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state + cfg.ssm_heads)
    return in_proj + conv_dim * cfg.ssm_conv + di * d + 3 * cfg.ssm_heads + 2 * d + di
