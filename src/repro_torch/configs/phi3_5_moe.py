"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16e top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

# the reference's `configs/qwen2_vl_72b.py` defines this string; the port
# keeps its own copy in each config
FULL_ATTN_SKIP = (
    "long_500k skipped: pure full-attention arch (see DESIGN.md §4)"
)


def model_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32064,
        n_experts=16,
        moe_top_k=2,
        moe_layer_step=1,
        capacity_factor=1.25,
        act="gelu",  # phi3.5 uses gated... simplified to gelu experts
    )


def bundle() -> ArchBundle:
    return ArchBundle(
        model=model_config(),
        parallel=ParallelConfig(
            seq_shard=True,
            fsdp=True,
            remat="block",
            kv_cache_dtype="int8",
            grad_accum={"train_4k": 2},
            logit_chunk=1024,
        ),
        skip_shapes={"long_500k": FULL_ATTN_SKIP},
    )
