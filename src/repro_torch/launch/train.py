"""Training CLI: the LM train step under the fault-tolerant loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --steps 50 --ckpt DIR [--device cuda]

The port of `repro/launch/train.py`, with its flags plus `--device`: the
arch's bundle with 2-way gradient accumulation, chunked cross-entropy
(chunks of min(64, seq) tokens) and float32 AdamW states; weights from a
generator seeded 0; batches from the synthetic token stream (seed 0),
prefetched on a thread. `TrainLoop` checkpoints every
`--checkpoint-every` steps and at the end into `--ckpt` (default: a
directory under the temporary directory) and resumes from its latest
checkpoint. Runs on `cuda` unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.configs.registry import get_arch
from repro_torch.data.lm_data import PrefetchIterator, synthetic_token_stream
from repro_torch.distributed import training as tr
from repro_torch.distributed.fault_tolerance import FaultPolicy, TrainLoop
from repro_torch.utils import resolve_device

ACCUM = 2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", type=str, default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.batch % ACCUM:
        ap.error(f"--batch must be a multiple of {ACCUM}")

    device = resolve_device(args.device)
    bundle = get_arch(args.arch)
    cfg = reduce_config(bundle.model) if args.reduced else bundle.model
    pcfg = bundle.parallel.with_(
        grad_accum={"cli": ACCUM}, logit_chunk=min(64, args.seq),
        opt_state_dtype="float32", fsdp=False, seq_shard=False)
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    step_fn = tr.make_train_step(cfg, pcfg, shape, base_lr=3e-4, warmup=20,
                                 total_steps=args.steps)
    mb = args.batch // ACCUM

    def batches():
        for item in synthetic_token_stream(cfg.vocab_size, args.seq,
                                           args.batch, seed=0):
            yield {k: item[k].reshape(ACCUM, mb, args.seq)
                   for k in ("tokens", "labels")}

    data = PrefetchIterator(batches(), depth=2)
    loop = TrainLoop(step_fn, Checkpointer(args.ckpt, keep=2, async_=True),
                     FaultPolicy(checkpoint_every=args.checkpoint_every))
    state, start = loop.resume_or_init(lambda: tr.init_train_state(
        cfg, pcfg, torch.Generator(device=device).manual_seed(0), device))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[train] {cfg.name} reduced={args.reduced} start={start} "
          f"on {name}")
    state, end = loop.run(state, data, args.steps, start_step=start)
    losses = [r.metrics["loss"] for r in loop.records]
    if losses:
        print(f"[train] done: steps {start}->{end}, loss "
              f"{losses[0]:.3f} -> {losses[-1]:.3f}")
    return state, loop


if __name__ == "__main__":
    main()
