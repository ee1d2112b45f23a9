"""--arch registry of the port: the dense LM configs that fit one card.

The reference's other architectures (MoE, SSM, hybrid, audio, VLM) are
still to port (ROADMAP.md, queue A.5); asking for one raises `KeyError`.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchBundle

ARCH_IDS = ("qwen3-8b", "qwen2.5-3b", "chatglm3-6b")

_MODULES = {
    "qwen3-8b": "qwen3_8b",
    "qwen2.5-3b": "qwen2_5_3b",
    "chatglm3-6b": "chatglm3_6b",
}


def get_arch(arch_id: str) -> ArchBundle:
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is not ported (see ROADMAP.md, "
                       f"queue A.5); ported: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.bundle()
