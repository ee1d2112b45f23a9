"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

# the reference's `configs/qwen2_vl_72b.py` defines this string; the port
# keeps its own copy in each config
FULL_ATTN_SKIP = (
    "long_500k skipped: pure full-attention arch (see DESIGN.md §4)"
)


def model_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        rope_theta=1e6,
        qk_norm=True,
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
            logit_chunk=1024,
        ),
        skip_shapes={"long_500k": FULL_ATTN_SKIP},
    )
