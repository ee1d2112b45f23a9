"""Serving driver: batched greedy generation through prefill + decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        [--reduced] [--batch 4] [--prompt-len 32] [--gen 16] [--device cuda]

The port of `repro/launch/serve.py` for any of the ten archs of
`configs/registry.py`: random weights from seed 0, prompt tokens from
numpy's seeded generator (the audio model's a (batch, K, prompt-len)
codebook grid; the VLM's prompt also carries `vision_tokens` random patch
embeddings at distinct random slots of each row), an int8 or bfloat16 KV
cache as the arch's bundle says (bfloat16 for `--reduced`). Runs on
`cuda` unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.reduced import reduce_config
from repro_torch.configs.registry import get_arch
from repro_torch.models import transformer as tf
from repro_torch.models.layers import param_dtype
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
    batch = prompt_batch(cfg, args.batch, args.prompt_len, device)

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


def prompt_batch(cfg, batch: int, prompt_len: int, device) -> dict:
    """The reference CLI's seeded prompt (numpy, seed 0) as tensors."""
    rng = np.random.default_rng(0)
    if cfg.family == "audio":
        toks = rng.integers(0, cfg.vocab_size,
                            (batch, cfg.n_codebooks, prompt_len))
    else:
        toks = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    out = {"tokens": torch.as_tensor(toks, dtype=torch.int32,
                                     device=device)}
    if cfg.family == "vlm":
        nv = cfg.vision_tokens
        if nv > prompt_len:
            raise ValueError(f"{cfg.name}: {nv} vision tokens need a prompt "
                             f"of at least {nv}, got {prompt_len}")
        out["vision_embeds"] = torch.as_tensor(
            rng.normal(size=(batch, nv, cfg.d_model)), dtype=torch.float32,
            device=device).to(param_dtype(cfg))
        out["vision_pos"] = torch.as_tensor(
            np.stack([rng.choice(prompt_len, size=nv, replace=False)
                      for _ in range(batch)]), dtype=torch.int32,
            device=device)
    return out


if __name__ == "__main__":
    main()
