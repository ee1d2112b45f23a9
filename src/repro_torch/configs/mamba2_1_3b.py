"""mamba2-1.3b [ssm]: 48L d_model=2048 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060].

Runs long_500k (O(1)-state decode). The paper's NNS/TCAM component is
inapplicable (no retrieval path) — see DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig


def model_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_conv=4,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=256,
        ssm_ngroups=1,
        tie_embeddings=True,
    )


def bundle() -> ArchBundle:
    return ArchBundle(
        model=model_config(),
        parallel=ParallelConfig(
            seq_shard=True,
            fsdp=False,
            remat="block",
            grad_accum={"train_4k": 1},
            logit_chunk=2048,
        ),
        skip_shapes={},
    )
