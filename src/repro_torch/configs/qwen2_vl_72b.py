"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Vision frontend is a stub per the assignment: input_specs() provides
precomputed patch embeddings + M-RoPE positions.
"""
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL_ATTN_SKIP = (
    "long_500k skipped: pure full-attention arch (see DESIGN.md §4)"
)


def model_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        rope_theta=1e6,
        rope_style="mrope",
        mrope_sections=(16, 24, 24),
        qkv_bias=True,
        vision_tokens=256,
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
            grad_accum={"train_4k": 4},
            logit_chunk=512,
        ),
        skip_shapes={"long_500k": FULL_ATTN_SKIP},
    )
