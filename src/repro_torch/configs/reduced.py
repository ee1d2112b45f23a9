"""Reduced-config factory: same family/topology, tiny dims — used by the
per-arch smoke tests (the FULL configs are exercised only via the dry-run)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    kw = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        vocab_size=128,
        dtype="float32",  # smoke tests check numerics, fp32 avoids bf16 noise
    )
    if cfg.n_heads:
        n_kv = 1 if cfg.n_kv_heads == 1 else 2
        kw.update(
            n_heads=4,
            n_kv_heads=min(4, max(n_kv, 4 // max(cfg.q_per_kv, 1))),
            head_dim=16,
            d_ff=128 if cfg.d_ff else 0,
        )
        if cfg.rope_style == "mrope":
            kw.update(mrope_sections=(2, 3, 3))  # sums to head_dim/2
    if cfg.n_experts:
        kw.update(n_experts=4, capacity_factor=2.0)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=8, ssm_chunk=8)
        # d_inner = 128 -> 16 heads of dim 8
    if cfg.attn_every:
        kw.update(n_layers=5, attn_every=2)  # exercises the remainder group
    if cfg.family == "audio":
        kw.update(n_codebooks=2, vocab_size=64)
    if cfg.family == "vlm":
        kw.update(vision_tokens=4)
    return cfg.with_(**kw)
