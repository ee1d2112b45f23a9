"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf]. Shared block applied before every 6 mamba layers
(+ once for the 2-layer remainder): 7 invocations, weights shared,
per-invocation KV cache. Runs long_500k (hybrid; decode attention uses the
sharded flash-decode path)."""
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig


def model_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=32000,
        ssm_state=64,
        ssm_conv=4,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=256,
        ssm_ngroups=1,
        attn_every=6,
    )


def bundle() -> ArchBundle:
    return ArchBundle(
        model=model_config(),
        parallel=ParallelConfig(
            seq_shard=True,
            fsdp=False,
            remat="block",
            kv_cache_dtype="int8",
            grad_accum={"train_4k": 1},
            logit_chunk=2048,
        ),
        skip_shapes={},
    )
