"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1, shared expert, alternating
dense/MoE layers [hf:meta-llama/Llama-4-*]. Early-fusion multimodality is a
stub (text tokens only) per the assignment."""
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

# the reference's `configs/qwen2_vl_72b.py` defines this string; the port
# keeps its own copy in each config
FULL_ATTN_SKIP = (
    "long_500k skipped: pure full-attention arch (see DESIGN.md §4)"
)


def model_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        rope_theta=5e5,
        n_experts=128,
        moe_top_k=1,
        moe_layer_step=2,  # alternating dense / MoE
        n_shared_experts=1,
        capacity_factor=1.25,
    )


def bundle() -> ArchBundle:
    return ArchBundle(
        model=model_config(),
        parallel=ParallelConfig(
            seq_shard=True,
            fsdp=True,
            remat="block",
            kv_cache_dtype="int8",
            opt_state_dtype="int8",
            serve_weight_sharding="2d",
            grad_accum={"train_4k": 2},  # §Perf iteration 3
            logit_chunk=512,
            moe_shard_ff=True,  # §Perf iteration 2: no expert-weight gathers
        ),
        skip_shapes={"long_500k": FULL_ATTN_SKIP},
    )
