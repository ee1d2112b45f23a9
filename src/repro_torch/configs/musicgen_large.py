"""musicgen-large [audio]: 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens, 4 codebooks with delay
pattern [arXiv:2306.05284; hf]. EnCodec itself is a stub per the
assignment; inputs are 4-codebook token grids. The per-step sum of 4
codebook embeddings is the iMARS multi-table pooled ET lookup on the LM
hot path (DESIGN.md §4). As in the reference, the delay pattern is named
here only: no code applies it."""
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig
from repro_torch.configs.qwen2_vl_72b import FULL_ATTN_SKIP


def model_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        act="gelu",
        n_codebooks=4,
    )


def bundle() -> ArchBundle:
    return ArchBundle(
        model=model_config(),
        parallel=ParallelConfig(
            seq_shard=True,
            fsdp=False,
            remat="block",
            kv_cache_dtype="int8",  # §Perf iteration 1 (iMARS ET quantization)
            grad_accum={"train_4k": 1},
            logit_chunk=0,
        ),
        skip_shapes={"long_500k": FULL_ATTN_SKIP},
    )
