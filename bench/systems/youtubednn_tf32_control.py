"""The control of the YoutubeDNN comparison: the plain reference put in the
program's place one precision below the configuration's, TF32 operands in
every MLP and projection (`Reference(tf32=True)`).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace 0 --system youtubednn_tf32_control

runs a cell with it through the same loop, sample and comparison as the
program, and `correct` has to come out false (it is not traced). It
imports nothing of the program; the benchmark's own runs never load it.
"""
from __future__ import annotations

from pathlib import Path

import torch

from bench.spec import load_module
from bench.weights import make_weights

ROOT = Path(__file__).resolve().parents[2]


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, pool):
        ref_mod = load_module(ROOT, "reference", cfg["reference"])
        params, proj = make_weights(cfg, seed, device)
        self.ref = ref_mod.Reference(params, proj, cfg, tf32=True)
        self.batch, self.top_k = traffic["batch"], cfg["top_k"]

    def answer_buffers(self, pin: bool) -> tuple:
        shape = (self.batch, self.top_k)
        return (torch.empty(shape, dtype=torch.int32, pin_memory=pin),
                torch.empty(shape, dtype=torch.float32, pin_memory=pin))

    def serve(self, inputs: dict) -> dict:
        """The reference's candidates and top-k, under the names that the
        comparison reads."""
        return self.ref.serve(inputs)

    @staticmethod
    def answers(result: dict) -> tuple:
        return result["items"], result["scores"]

    @staticmethod
    def served(result: dict) -> dict:
        return result
