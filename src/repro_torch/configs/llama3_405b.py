"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 — GQA, 128k vocab [arXiv:2407.21783].

The heavyweight: FSDP + TP, int8 optimizer states (blockwise — the paper's
quantization applied to optimizer memory), int8 KV (required to fit
decode_32k on 256 v5e chips), 2D weight sharding for decode, 16-way gradient
accumulation for train_4k. All 126 layers hold 405.9 B params (812 GB in
bf16): one 80 GB card runs the config at full width with its depth cut.
"""
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig
from repro_torch.configs.qwen2_vl_72b import FULL_ATTN_SKIP


def model_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b",
        family="dense",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        head_dim=128,
        d_ff=53248,
        vocab_size=128256,
        rope_theta=5e5,
        # a sharding hint of the reference's (where its sequence-parallel
        # boundary sits around the kv repeat); kept so the config carries
        # across unchanged, it changes no number on one card
        opt_kv_layout=True,
    )


def bundle() -> ArchBundle:
    return ArchBundle(
        model=model_config(),
        parallel=ParallelConfig(
            fsdp=True,
            seq_shard=True,
            remat="block",
            kv_cache_dtype="int8",
            opt_state_dtype="int8",
            serve_weight_sharding="2d",
            grad_accum={"train_4k": 4},  # §Perf iteration 3/4
            logit_chunk=512,
            # int8 grad compression is exercised on the smaller archs; the
            # fp32 error-feedback buffer is not worth 405B params of HBM
            grad_compression=False,
        ),
        skip_shapes={"long_500k": FULL_ATTN_SKIP},
    )
