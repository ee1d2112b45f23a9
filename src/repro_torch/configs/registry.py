"""--arch registry of the port: every LM architecture of the reference
(dense, MoE, SSM, hybrid, audio and VLM), the same ids in the same order.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchBundle

ARCH_IDS = (
    "qwen2-vl-72b",
    "chatglm3-6b",
    "qwen3-8b",
    "qwen2.5-3b",
    "llama3-405b",
    "llama4-maverick-400b-a17b",
    "phi3.5-moe-42b-a6.6b",
    "mamba2-1.3b",
    "zamba2-1.2b",
    "musicgen-large",
)

_MODULES = {
    "qwen2-vl-72b": "qwen2_vl_72b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen3-8b": "qwen3_8b",
    "qwen2.5-3b": "qwen2_5_3b",
    "llama3-405b": "llama3_405b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "mamba2-1.3b": "mamba2_1_3b",
    "zamba2-1.2b": "zamba2_1_2b",
    "musicgen-large": "musicgen_large",
}


def get_arch(arch_id: str) -> ArchBundle:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.bundle()


def all_arches() -> dict[str, ArchBundle]:
    return {a: get_arch(a) for a in ARCH_IDS}
