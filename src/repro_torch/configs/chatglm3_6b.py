"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — RoPE 2d (partial rotary), GQA [arXiv:2406.12793; hf]."""
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

# the reference's `configs/qwen2_vl_72b.py` defines this string; the port
# keeps its own copy in each config
FULL_ATTN_SKIP = (
    "long_500k skipped: pure full-attention arch (see DESIGN.md §4)"
)


def model_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=65024,
        rope_fraction=0.5,  # chatglm's 2d rope: rotary on half the head dims
        qkv_bias=True,
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
