#!/usr/bin/env python3
"""Phase I's training stream at several base learning rates, on one GPU.

    python3 tools/lm_lr_sweep.py [--seed 0] LR [LR ...]

Trains `chip_smoke.py`'s phase I model (Qwen3-8B at full width, 4
layers, bf16, the bundle's remat and logit chunk, float32 AdamW; seq
2048, microbatch 2, accumulation 2) from the same seeded weights on the
same 31 batches of the synthetic token stream, once per base lr (warm-up
5 steps, cosine to step 31). Prints the card's name and power limit,
then per lr the mean ms a step (host clock, each step read back), the
fall of the loss (the first step's less the mean of the last five) and
every step's loss. Checks nothing.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data.lm_data import synthetic_token_stream  # noqa: E402
from repro_torch.distributed import training as tr  # noqa: E402
from repro_torch.utils import resolve_device  # noqa: E402

LAYERS, SEQ, MB, ACCUM, STEPS = 4, 2048, 2, 2, 31


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("lrs", type=float, nargs="+")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    bundle = get_arch("qwen3-8b")
    cfg = bundle.model.with_(n_layers=LAYERS)
    pcfg = bundle.parallel.with_(grad_accum={"sweep": ACCUM})
    shape = ShapeConfig("sweep", "train", SEQ, MB * ACCUM)
    stream = synthetic_token_stream(cfg.vocab_size, SEQ, MB * ACCUM,
                                    seed=args.seed)
    batches = [{k: item[k].reshape(ACCUM, MB, SEQ)
                for k in ("tokens", "labels")}
               for item, _ in zip(stream, range(STEPS))]
    for lr in args.lrs:
        step = tr.make_train_step(cfg, pcfg, shape, base_lr=lr, warmup=5,
                                  total_steps=STEPS)
        state = tr.init_train_state(
            cfg, pcfg, torch.Generator(device=device).manual_seed(args.seed),
            device)
        losses = []
        t0 = time.perf_counter()
        for batch in batches:
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        ms = (time.perf_counter() - t0) / STEPS * 1e3
        fall = losses[0] - sum(losses[-5:]) / 5
        print(f"lr {lr}: {ms:.1f} ms a step, fall {fall:.4f}, losses "
              f"{losses}", flush=True)
        del state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
