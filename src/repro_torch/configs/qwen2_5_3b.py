"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias, tied embeddings [hf:Qwen/Qwen2.5-*; hf]."""
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

# the reference's `configs/qwen2_vl_72b.py` defines this string; the port
# keeps its own copy in each config
FULL_ATTN_SKIP = (
    "long_500k skipped: pure full-attention arch (see DESIGN.md §4)"
)


def model_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b",
        family="dense",
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv_heads=2,
        head_dim=128,
        d_ff=11008,
        vocab_size=151936,
        rope_theta=1e6,
        qkv_bias=True,
        tie_embeddings=True,
    )


def bundle() -> ArchBundle:
    return ArchBundle(
        model=model_config(),
        parallel=ParallelConfig(
            seq_shard=True,
            fsdp=False,
            remat="block",
            kv_cache_dtype="bfloat16",
            grad_accum={"train_4k": 1},
            logit_chunk=1024,
        ),
        skip_shapes={"long_500k": FULL_ATTN_SKIP},
    )
