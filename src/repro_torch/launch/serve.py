"""Serving driver: batched greedy generation through prefill + decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        [--reduced] [--batch 4] [--prompt-len 32] [--gen 16] [--device cuda]

The port of `repro/launch/serve.py` for any arch of `configs/registry.py`
(dense, MoE, SSM, hybrid): random weights from seed 0, prompt
tokens from numpy's seeded generator, an int8 or bfloat16 KV cache as the
arch's bundle says (bfloat16 for `--reduced`). Runs on `cuda` unless
`--device cpu` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.reduced import reduce_config
from repro_torch.configs.registry import get_arch
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import LMServingEngine
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    bundle = get_arch(args.arch)
    cfg = reduce_config(bundle.model) if args.reduced else bundle.model
    gen = torch.Generator(device=device).manual_seed(0)
    params = tf.init_params(cfg, gen, device)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32,
                                       device=device)}

    engine = LMServingEngine(
        params, cfg, batch=args.batch,
        cache_len=args.prompt_len + args.gen + 4,
        cache_dtype=bundle.parallel.kv_cache_dtype
        if not args.reduced else "bfloat16")
    t0 = time.perf_counter()
    out = engine.generate(batch, args.gen)
    dt = time.perf_counter() - t0
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[serve] {cfg.name}: generated {out.tokens.shape} tokens in "
          f"{dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s on {name})")
    print(out.tokens[0])
    return out


if __name__ == "__main__":
    main()
