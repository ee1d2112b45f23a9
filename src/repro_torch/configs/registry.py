"""--arch registry of the port: the dense, MoE, SSM and hybrid LM configs.

The reference's other architectures (llama3-405b, audio, VLM) are still
to port (ROADMAP.md, queue A.5); asking for one raises `KeyError`.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchBundle

ARCH_IDS = (
    "chatglm3-6b",
    "qwen3-8b",
    "qwen2.5-3b",
    "llama4-maverick-400b-a17b",
    "phi3.5-moe-42b-a6.6b",
    "mamba2-1.3b",
    "zamba2-1.2b",
)

_MODULES = {
    "chatglm3-6b": "chatglm3_6b",
    "qwen3-8b": "qwen3_8b",
    "qwen2.5-3b": "qwen2_5_3b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "mamba2-1.3b": "mamba2_1_3b",
    "zamba2-1.2b": "zamba2_1_2b",
}


def get_arch(arch_id: str) -> ArchBundle:
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is not ported (see ROADMAP.md, "
                       f"queue A.5); ported: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.bundle()
