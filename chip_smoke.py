#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`), one GPU.

    python3 chip_smoke.py [--seed 0] [--record PATH]
    python3 chip_smoke.py --profile [--src DIR] [--seed 0]

1. Builds the five CUDA kernels from `src/repro_torch/kernels/csrc`.
2. Phase A: the paper's YoutubeDNN/MovieLens engine (3000 items, seeded
   random weights, 128 hot rows per table) serves 256-query batches through
   `RecSysEngine.serve` on the dense plan (Hamming kernel + stable top-K);
   each stage pools its tables in one grouped embedding-pool launch, so
   the pool launches twice a batch.
3. Phase B: the same model with a 1,048,576-item catalog (32 MB int8 table
   and 32 MB of signatures on the card) serves on the auto-routed, pruned
   streaming plan.
   Each phase zeroes the kernels' launch counters just before its serve
   loop and reads them just after. Its outputs are checked: shapes, ranges,
   finite scores, equality with the plain PyTorch versions on the card
   (`REPRO_TORCH_<OP>=torch`; cache counters included), and the NNS
   candidates of a CPU engine built from the same weights, given the
   card's query signatures. Then the host-clock time of each stage (the
   median over 5 steps), and `torch.profiler` over one serve step
   (kernels, device time, idle share).
4. Phase D: Qwen3-8B at full width and all 36 layers in bfloat16 (random
   weights from a seeded CUDA generator), batch 4, 2048 prompt tokens, 16
   generated, int8 KV cache. D.1 `LMServingEngine.generate`, the entry
   point as it stands (blocked prefill, no kernel); D.2 `prefill` with
   `attn_impl="flash"`, whose flash kernel must launch once per layer,
   whose layer-0 int8 cache must equal the blocked prefill's, and whose
   last-token logits must agree with it (max |diff| <= 5% of each row's
   spread; greedy token within 5% of the spread of the max); D.3 15
   teacher-forced `decode_step`s from the flash cache (finite logits; the
   token D.1 chose next within 5% of the spread of the max); D.4 the public
   `ops.int8_matmul` at `kernel_bench`'s 256x512x512 and at the MLP
   up-projection of the prompt tokens (8192x4096x12288, activations and
   weights quantized per row / column), within 5% of the bf16 product.
   Then `torch.profiler` traces one blocked prefill, one flash prefill and
   one decode step: kernels run, device time, and the idle share.
5. Phase E: the serving front-ends (`make_server`) over phase A's and B's
   engines. E.1: one seeded stream of 2,085 single-user queries (8 full
   256-query buckets and a 37-query tail) through sync, pipelined (depth 2)
   and concurrent (2 tenants, depth 2, an unbounded queue staged before the
   drain starts, so its buckets are sync's) serving: every ticket ok, no
   error, items, scores and cache counters bit-equal across the modes and
   to `RecSysEngine.serve` on the same stacked buckets, and per bucket 2
   pool launches, 1 Hamming launch, no streaming launch. E.2: 1,024 queries
   through sync and pipelined serving on the 1M-item pruned streaming plan:
   bit-equal, 1 streaming launch a bucket, the same blocks touched in the
   registry. Each mode is warmed, then its q/s is the median of 3 runs.
   E.3: a `LoadGen` replay (2 tenants, Zipf 1.1, 2048 queries, 2 s) into
   the concurrent front-end at half E.1's pipelined q/s, then at a tenth of
   it: p50 and p99 latency, shed and error tickets (errors fail). E.4:
   `ServeResult.cost` equals the paper's cost model, and `hit_rate` in
   fp32, int8 and lsh modes on the synthetic MovieLens set gives the same
   hit counts with the plain versions.
6. Phase F: the live and tiered catalogs. F.1: a seeded churn through
   `LiveCatalog` over phase A's engine (64 new ids past n, 16 hot-cached
   and 48 cold rows re-embedded, deletes, a delete and re-add, a retired
   new id in every history, 1000 new ids that fill the 1024-slot delta
   and force a compaction); after each update batch two 256-query batches
   serve bit-equal to `rebuild_reference()` on the card (items, scores,
   NNS, cache counters), 2 pool and 2 Hamming launches a batch (base and
   delta), no streaming launch; the same churn through sync and pipelined
   servers attached to one catalog serves equal bits. F.2: phase B's
   1,048,576 items, 1% tombstoned and 1024 rows re-embedded: bit-equal to
   `rebuild_reference()` (blocks touched included), 1 masked-pruned
   streaming, 1 Hamming and 2 pool launches a batch; then the compaction,
   timed. F.3: F.2's compacted catalog spilled to a base shard in a
   temporary directory (removed at the end) and served by `TieredCatalog`
   (pool 4096 rows, 128 hot): bit-equal to `to_ram_engine()`, 4 streaming
   launches a batch (chunks of 2^18 rows), 1 Hamming and 2 pool; churn,
   compaction and a check against `rebuild_reference()`; snapshot and
   restore serving the same bits. Times: serve ms a batch, frozen and
   live on the same batches; tiered ms a batch, its out-of-core scan and
   its host overlays; bytes staged; resident bytes; compactions.
7. Phase G: training and train-while-serve at full width, on the
   synthetic MovieLens-1M set (6,040 users, 3,000 items, history 20).
   G.1: `init_youtubednn` from a seeded CUDA generator, 400 filtering steps
   of `make_recsys_train_step` (batch 256), then 200 AdamW ranking steps
   (batch 128, 16 candidates): the filtering loss must fall by 0.5; ms a
   step (host clock, synchronized, median) and `torch.profiler` over one
   filtering step. G.2: the trained engine (radius 112, 64 candidates, 128
   hot rows) gives HR@10 in fp32, int8 and lsh modes over every user, in
   the reference's order (fp32 > 1.2x chance, |fp32 - int8| < 0.02, lsh
   <= int8 + 0.01). G.3: an `OnlineTrainer` (fold every step, compaction
   every 4 folds) over a `LiveCatalog` of it (a 3,000-slot delta) trains
   40 steps on a thread while a concurrent front-end serves 1,024-query
   rounds: no error ticket, 40 folds, at least 3 epochs, 2 pool and 2
   Hamming launches a bucket served (base and delta scans); q/s against
   the same rounds on the frozen engine before and after, staleness, ms a
   fold and a compaction; then `ShadowHarness` checkpoints now and after
   10 and 20 more steps, each with gap 0 and full agreement. G.4: a step
   without a fold leaves the served bits and `engine.params` unchanged.
   G.5: a `TrainLoop` of 10 steps (checkpoint every 5, no straggler
   check) stopped by a hard fault at step 7 resumes from step 5 and ends
   bit-equal to an uninterrupted run. G.6: DLRM at its Table I size, 150
   AdamW steps of 256: the loss must fall by 0.05.
8. Phase H: the multi-GPU RecSys plans (`RecSysEngine.shard`, the mesh
   plans of `core/nns.py`, `core/hierarchy.py`). H.1: a world-size-1 NCCL
   group (`file://` rendezvous in a temporary directory, removed at the
   end); phase A's and B's engines, sharded over the banks, over a query
   axis and over a 1 x 1 grid of both, serve their batches bit-equal to
   the unsharded engines (items, scores, NNS, blocks touched, cache
   counters) with the same launches; a LiveCatalog update batch and a
   compaction (which re-shards onto the mesh) on the grid engine, each
   bit-equal to `rebuild_reference()`. H.2: banks on one card with no
   collective: phase B's 1,048,576 rows as 4 pruned banks of 262,144
   (whole 4,096-row summary blocks) and phase A's 3,000 rows as 3 and as
   7 dense banks (7 pad the rows), each bank through `bank_scan`, then
   `merge_banks`: bit-equal to the local plan and to the plain versions,
   the ms of each bank's scan beside the one full-catalog scan; and
   `sharded_embedding_bag`'s decomposition over 4 banks of phase A's item
   table on the pool kernel, bit-equal to the plain versions and within
   1e-6 of the one-table pool. H.1's launches count in the kernel table;
   H.2's are comparisons and do not.
9. Phase I: LM training on the card (`distributed.training`), Qwen3-8B
   at full width (d_model 4096, 32 heads over 8 kv heads, head_dim 128,
   d_ff 12288, vocab 151,936, qk-norm) with its depth cut to 4 layers
   (36 do not fit one card in training: ~28 bytes a param), bf16 weights
   from a seeded CUDA generator, the bundle's `remat="block"` and
   `logit_chunk=1024`, float32 AdamW states, base lr 5e-4 (warm-up 5,
   cosine), the synthetic token stream of `data/lm_data.py` through its
   prefetcher: seq 2048, microbatch 2, accumulation 2 (8,192 tokens a
   step). I.1: the chunked loss equals the unchunked one within 1e-3
   relative (bf16 logits from GEMMs of another shape) and the first
   step's loss and grad norm are finite. I.2: the blocked attention's
   custom backward at one layer's shape (B 2, 8 x 4 heads, S 2048, hd
   128, float32) against autograd through the materialized softmax, dq,
   dk, dv within 1e-4 of each one's largest magnitude; its forward and
   backward timed with TF32 off (as the port runs) and on. I.5: two runs
   of the first step from one state give the same bits (parameters
   compared whole, every other tensor by an exact integer digest). I.3:
   30 more steps: the last five steps' mean loss at least 0.05 below the
   first step's; ms a step (host clock, synchronized, median), tokens/s,
   `mfu` (PaLM's model flops over 989 TFLOP/s), `torch.profiler` over
   one step (device ms, idle share, ms by kernel kind, the top kernels),
   peak memory. I.4: 6 steps each with int8 AdamW states and with int8
   gradient compression, each loss within 0.25 of the float32 run's at
   the same step. No port kernel may launch in phase I: the reference
   trains through its blocked attention, never its Pallas kernel.
10. Phase C: each kernel against its plain version on the card at the
   phases' shapes: the Hamming kernel at phase A's shape and at the largest
   dense catalog (262,143 rows), beside its bytes bound and the POPC floor
   of any CUDA-core design; the grouped pool at phase A's lookup-stage and
   rank-stage segment lists (one launch each; device and wall time a call),
   at F.1's live engine's (the 1024-slot delta as the history's and the
   candidates' side table, its bytes in the bound), at the tiered rank
   stage (a per-call 12,800-slot overlay, no base rows), and as the
   single-table public op; the streaming kernel also masked,
   unpruned, with a `superblock` override and against the dense plan;
   flash also in float32 with a ragged kv length and `q_offset`. Integer
   outputs, the pool (counters included) and the int8 matmul must be
   equal, flash within 2e-2 (bf16) and 2e-5 (f32); the flash kernel is
   also timed in float32 at phase D's shape (its CUDA-core path). Kernel
   times are CUDA-event means over back-to-back launches queued behind a
   spin (warm L2, as in the serve loop); the wall time per call, host
   included, goes to the record as `call_ms`. `library_ms` times one
   PyTorch call of the same function where there is one
   (`scaled_dot_product_attention`; `torch._int_mm` and the two scale
   multiplies, with W in both layouts, (k, n) row-major and the K-major
   view of its transpose, the faster kept); the port never calls either.
   The streaming kernel's bound is the faster of its two engines (the +-1
   int8 product on the tensor cores, or XOR-popcount on the CUDA cores).
   Informative lines the port never calls: `torch._int_mm` on the
   +-1-expanded operands of the streaming and Hamming kernels (the
   distance product alone), and `F.embedding_bag` over the dequantized f32
   tables of the lookup stage.

Runs A, B, E, F, G, H, D, I, C in that order. Prints one line per phase
(phase E's, F's and I's with the card's name and power limit), one line
per kernel, the card's name and power limit as `nvidia-smi` gives them,
a `kernels` JSON line, and last `{"ok": true, "device": {...}}`;
`--record PATH` also writes the full record as JSON. Any failure exits
nonzero. Without a GPU, or without the repository beside it, it exits 1
and prints no result.

`--profile` runs only the timing of phases A and B's serve steps (stages,
serve step, profile) and of the Hamming op, with the port imported from
`--src` (default: this checkout's `src`): run it on a parent tree unpacked
with `git archive` and on this one, in one call, to compare them on one
card. It checks nothing and prints no kernel table.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# peak of plain (non-tensor-core) arithmetic: the float32 rate, used as an
# upper bound on the rate of integer XOR / popcount / add (Hopper executes
# popcount at a lower rate, so the true bound is higher than this one)
CUDA_CORE_OPS_PER_S = 67e12
# dense tensor-core peaks (data sheet, SXM part): what the attention flops
# and the int8 products are bounded by
BF16_TC_FLOPS = 989e12
INT8_TC_OPS = 1979e12
# the CUDA cores' popcount rate: `POPC` issues at 16 a clock per SM on
# sm_90 (132 SMs at the 1.98 GHz boost clock), the floor of any XOR-popcount
# Hamming design
POPC_PER_S = 132 * 16 * 1.98e9
BATCH = 256
N_BATCHES_A = 4
N_BATCHES_B = 3
N_ITEMS_B = 1 << 20
HOT_ROWS = 128
# serve steps behind each stage-time median: a checked run, and `--profile`
# (whose medians compare two trees)
STEPS = 5
PROFILE_STEPS = 20
POOL_RTOL = 1e-5
# ~50 ms of GPU clock: longer than the host takes to queue a timing loop
SPIN_CYCLES = 100_000_000
# phase D: Qwen3-8B serving, and the tolerances of its comparisons
LM_ARCH = "qwen3-8b"
LM_BATCH = 4
LM_PROMPT = 2048
LM_GEN = 16
SPREAD_FRAC = 0.05  # tests/test_serving.py's gap criterion
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# (name, bh, sq, sk, d, dtype, q_offset): phase D's attention (32 heads x
# batch 4), then float32 with a ragged kv length and the causal offset
FLASH_CASES = (("phase D", 128, 2048, 2048, 128, torch.bfloat16, 0),
               ("f32 ragged", 8, 300, 1000, 128, torch.float32, 700))
# phase E: the serving front-ends. 2,085 queries are 8 full buckets and a
# 37-query tail (the 64 bucket); the load replay runs at half the
# pipelined rate of E.1
N_QUERIES_E1 = 8 * BATCH + 37
N_QUERIES_E2 = 4 * BATCH
LOAD_S = 2.0
LOAD_TENANTS = 2
LOAD_POOL = 2048
LOAD_FRACS = (0.5, 0.1)
# phase G: training and train-while-serve (examples/train_recsys.py's
# recipe with the reference's AdamW; its engine's radius and candidates)
G_BATCH = 256
G_FILTER_STEPS = 400
G_RANK_STEPS = 200
G_RANK_BATCH = 128
G_CANDS = 16
G_RADIUS = 112
G_CANDIDATES = 64
G_QUERIES = 4 * BATCH
G_FROZEN_ROUNDS = 10
G_ONLINE_STEPS = 40
G_DLRM_STEPS = 150
# phase I: LM training, Qwen3-8B at full width with its depth cut to 4
# layers (36 do not fit: ~8.2 B params at ~28 bytes a param in a step);
# microbatch 2 x 2048 tokens, accumulation 2: 8,192 tokens a step
I_LAYERS = 4
I_SEQ = 2048
I_MB = 2
I_ACCUM = 2
I_STEPS = 30  # timed steps after the first (checked) one
I_VARIANT_STEPS = 6
# base lr 1e-3 spiked the loss at full width (12.39 -> 12.86 as the
# warm-up reached it); 5e-4 is the largest of 1e-4 .. 5e-4 that fell
# steadily (PERF.md, section 6)
I_SCHEDULE = dict(base_lr=5e-4, warmup=5, total_steps=I_STEPS + 1)
I_FALL = 0.05  # the last five steps' mean loss below the first step's
I_CHUNK_RTOL = 1e-3  # bf16 logits of another GEMM shape, summed otherwise
I_ATTN_TOL = 1e-4  # of each gradient's largest magnitude: f32 sums of
#                    2,048 terms in other orders
I_VARIANT_GAP = 0.25  # tests/test_training.py's bound between variants
# a train step's kernels by kind, by name: cuBLAS runs the bf16 GEMMs as
# `nvjet` kernels and, with TF32 off, the attention's float32 einsums as
# `f32f32` FFMA ones; eager ops are `elementwise`, `reduce` or `copy`
I_PROFILE_GROUPS = {"bf16 GEMM": ("nvjet",),
                    "f32 GEMM (attention)": ("gemm", "f32f32"),
                    "other GEMM": ("gemm",),
                    "reductions": ("reduce",),
                    "copies and casts": ("copy",),
                    "elementwise": ("elementwise",)}
WAIT_S = 120.0  # the longest wait for a ticket or the training thread
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def plain_versions():
    """Route every kernel op to its plain PyTorch version on the card."""
    names = [f"REPRO_TORCH_{op}" for op in
             ("HAMMING_DISTANCES", "EMBEDDING_POOL", "STREAMING_NNS",
              "FLASH_ATTENTION", "INT8_MATMUL")]
    old = {k: os.environ.get(k) for k in names}
    os.environ.update({k: "torch" for k in names})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# seeded weights and traffic
# ---------------------------------------------------------------------------
def numpy_params(cfg, seed: int) -> dict:
    """Random YoutubeDNN weights in the reference's layout and scales."""
    rng = np.random.default_rng(seed)
    d = cfg.embed_dim

    def normal(shape, scale):
        return (scale * rng.standard_normal(shape, dtype=np.float32)
                ).astype(np.float32)

    def mlp(dims):
        return [{"w": normal((a, b), a ** -0.5),
                 "b": np.zeros((b,), np.float32)}
                for a, b in zip(dims[:-1], dims[1:])]

    n_feats = len(cfg.user_features) + 1
    return {
        "tables": {name: normal((card, d), 0.05)
                   for name, card in sorted(cfg.user_features.items())},
        "item_table": normal((cfg.n_items, d), 0.05),
        "genre_table": normal((18, d), 0.05),
        "filter_mlp": mlp((n_feats * d,) + tuple(cfg.filter_dims)),
        "rank_mlp": mlp((4 * d,) + tuple(cfg.rank_dims)),
    }


def popular_items(rng, n_items: int, shape) -> np.ndarray:
    """Zipf-skewed item ids (popular items are the low ids, shuffled)."""
    return ((rng.zipf(1.2, size=shape) - 1) % n_items).astype(np.int32)


def make_batch(rng, cfg, n: int) -> dict:
    batch = {name: rng.integers(0, card, n).astype(np.int32)
             for name, card in cfg.user_features.items()}
    hist = popular_items(rng, cfg.n_items, (n, cfg.history_len))
    lengths = rng.integers(5, cfg.history_len + 1, n)
    hist[np.arange(cfg.history_len)[None, :] >= lengths[:, None]] = -1
    batch["history"] = hist
    batch["genre"] = rng.integers(0, 18, n).astype(np.int32)
    return batch


def serve_inputs(seed: int, device):
    """The seeded inputs of phases A and B, drawn in one fixed order: the
    torch generator (it also draws phase C's streaming mask later), the
    LSH projections, and per phase its config, weights, item frequencies
    (for the hot set) and batches."""
    from repro_torch.core.lsh import make_lsh_projections
    from repro_torch.models.recsys import default_youtubednn_config

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    cfg = default_youtubednn_config()
    proj = make_lsh_projections(cfg.embed_dim, 256, generator=gen,
                                device=device)
    phases = {}
    for name, cfg_p, p_seed, n_batches, n_freq in (
            ("A", cfg, seed, N_BATCHES_A, 1 << 16),
            ("B", cfg._replace(n_items=N_ITEMS_B), seed + 1, N_BATCHES_B,
             1 << 18)):
        params = numpy_params(cfg_p, p_seed)
        freqs = np.bincount(popular_items(rng, cfg_p.n_items, n_freq),
                            minlength=cfg_p.n_items)
        batches = [make_batch(rng, cfg_p, BATCH) for _ in range(n_batches)]
        phases[name] = {"cfg": cfg_p, "params": params, "freqs": freqs,
                        "batches": batches}
    return gen, proj, phases


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def timed_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back runs between one
    pair of CUDA events, after a warm-up. A spin kernel holds the card
    first, so the host has queued every launch before the start event
    fires and the host's per-call overhead stays out of the figure. The L2
    stays warm, as in the serve loop, where the signatures (at most 32 MB
    here) outlive a batch in the 50 MB L2."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, reps: int) -> float:
    """Wall time per call of `fn` with the card otherwise idle: what a
    caller pays per launch, host overhead included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations"))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def serve_phase(engine, batches, n_expected_items, ops) -> dict:
    """Serve `batches`, counting kernel launches over exactly that loop."""
    engine.serve(batches[0])  # warm-up: libraries, cuBLAS handles
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    results = [engine.serve(b) for b in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    for r in results:
        items, top = r.items, r.topk
        check(items.shape == (BATCH, engine.top_k), f"items {items.shape}")
        check(bool(((items >= -1) & (items < n_expected_items)).all()),
              "item id out of range")
        ok = top.indices >= 0
        check(bool(torch.isfinite(top.scores[ok]).all()), "non-finite CTR")
        check(bool(((top.scores[ok] >= 0) & (top.scores[ok] <= 1)).all()),
              "CTR outside [0, 1]")
        d = r.nns.distances
        check(bool((d[:, 1:] >= d[:, :-1]).all()), "NNS not sorted")
        check(bool((d[r.nns.indices >= 0] <= engine.radius).all()),
              "candidate beyond the radius")
    with plain_versions():
        plain = [engine.serve(b) for b in batches]
    for r, p in zip(results, plain):
        for f in ("indices", "distances", "counts"):
            check(torch.equal(getattr(r.nns, f), getattr(p.nns, f)),
                  f"NNS {f} differ from the plain versions")
        if r.nns.blocks_touched is not None:
            check(torch.equal(r.nns.blocks_touched, p.nns.blocks_touched),
                  "blocks_touched differ")
        check(torch.equal(r.items, p.items), "items differ from plain")
        check(torch.allclose(r.topk.scores, p.topk.scores, rtol=POOL_RTOL,
                             atol=0), "CTR differ from plain")
        check(r.stats.as_dict() == p.stats.as_dict(), "cache stats differ")
    stats = results[0].stats
    for r in results[1:]:
        stats = stats + r.stats
    return {"results": results, "launches": launches,
            "ms_per_batch": wall / len(batches) * 1e3,
            "queries_per_s": len(batches) * BATCH / wall,
            "cache": stats.as_dict(),
            "candidates_per_query": float(torch.cat(
                [r.nns.counts for r in results]).float().mean())}


def stage_ms(engine, batch, rs_mod) -> dict:
    """Host-clock time of each stage of one serve step (synchronized)."""
    from repro_torch.serving.hot_cache import CacheStats

    b = engine.batch_to_device(batch)
    out = {}

    def clock(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
        return r

    for _ in range(2):  # the second pass is the one kept
        u, pooled, _ = clock("lookup", lambda: rs_mod._lookup_stage(
            engine, b, CacheStats.zero(engine.device)))
        nns = clock("scan", lambda: rs_mod._scan_stage(engine, u))
        clock("rank", lambda: rs_mod._rank_stage(
            engine, b, nns.indices, u, pooled,
            CacheStats.zero(engine.device)))
    return out


def step_times(engine, batch, rs_mod, ops, steps: int) -> dict:
    """Where one serve step of `batch` spends its time: each stage's
    host-clock ms (`stage_ms`), the median over `steps` steps; the mean
    wall ms of `steps` serve steps; and `serve_profile` of one step."""
    for _ in range(3):  # warm-up: libraries, handles, allocator
        engine.serve(batch)
    torch.cuda.synchronize()
    stages = [stage_ms(engine, batch, rs_mod) for _ in range(steps)]
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.serve(batch)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) / steps * 1e3
    return {"stage_ms": {k: statistics.median(st[k] for st in stages)
                         for k in stages[0]},
            "serve_ms": serve_ms,
            "profile": serve_profile(engine, batch, ops)}


def cpu_reference_check(params, cfg, proj, gpu_engine, batch, rs_mod):
    """A CPU engine from the same weights: same NNS given the card's query
    signatures, and user embeddings within 1e-5 (different matmuls)."""
    from repro_torch.core.lsh import lsh_signature

    cpu = rs_mod.RecSysEngine.build(
        params, cfg, lsh_proj=proj.cpu(), hot_rows=HOT_ROWS,
        radius=gpu_engine.radius, device="cpu")
    small = {k: v[:16] for k, v in batch.items()}
    u_gpu = gpu_engine.user_embedding(small)
    u_cpu = cpu.user_embedding(small)
    err = float((u_gpu.cpu() - u_cpu).abs().max())
    check(err <= 1e-5 * max(1.0, float(u_cpu.abs().max())),
          f"user embedding differs from the CPU engine by {err}")
    sigs = lsh_signature(u_gpu, gpu_engine.lsh_proj)
    agree = float((sigs.cpu() == lsh_signature(u_cpu, cpu.lsh_proj))
                  .float().mean())
    n_gpu = rs_mod._nns(gpu_engine, sigs)
    n_cpu = rs_mod._nns(cpu, sigs.cpu())
    for f in ("indices", "distances", "counts"):
        check(torch.equal(getattr(n_gpu, f).cpu(), getattr(n_cpu, f)),
              f"NNS {f} differ from the CPU engine")
    return {"u_max_abs_err": err, "query_sig_word_agreement": agree}


# ---------------------------------------------------------------------------
# phase E: the serving front-ends on the card
# ---------------------------------------------------------------------------
class GcPauses:
    """Python's full (generation-2) garbage collections inside `with`
    blocks: their count and longest and total pause, summed over every
    block this object timed. A pause stops every thread of the process,
    so it lands on whichever tickets are in flight."""

    def __init__(self):
        self.pauses: list[float] = []
        self._t0 = None

    def _callback(self, phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append(time.perf_counter() - self._t0)
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)

    def summary(self) -> dict:
        return {"gen2_collections": len(self.pauses),
                "gen2_max_ms": max(self.pauses, default=0.0) * 1e3,
                "gen2_total_ms": sum(self.pauses) * 1e3}


def split_queries(batch: dict) -> list[dict]:
    """A stacked batch as single-user queries (the front-ends' `submit`
    schema: user-feature scalars, the history vector, the genre)."""
    n = batch["genre"].shape[0]
    return [{k: v[i] for k, v in batch.items()} for i in range(n)]


def run_mode(eng, mode: str, knobs: dict, queries, ops) -> dict:
    """One fresh `make_server(eng, mode)` serving `queries`, its kernel
    launches counted over exactly that run; every ticket must be ok and
    the server must report no error."""
    from repro_torch.serving import make_server

    server = make_server(eng, mode, max_batch=BATCH, **knobs)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    served = server.serve_many(queries)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    st = server.stats()
    snap = server.snapshot()
    server.close()
    check(all(s.status == "ok" for s in served),
          f"{mode}: tickets not ok: {sorted({s.status for s in served})}")
    check(st["n_served"] == len(queries) and st["n_errors"] == 0
          and st["last_error"] is None,
          f"{mode}: served {st['n_served']} of {len(queries)}, errors "
          f"{st['n_errors']}, last error {st['last_error']}")
    return {"items": np.stack([s.items for s in served]),
            "scores": np.stack([s.scores for s in served]),
            "launches": launches,
            "wall_s": wall, "stats": st,
            "blocks_touched": snap.get("nns.blocks_touched", 0),
            # host-clock ms a bucket, from the server's stage histograms
            "stage_ms": {s: snap[f"serving.stage.{s}_s.mean"] * 1e3
                         for s in ("dispatch", "scan", "rank")
                         if f"serving.stage.{s}_s.mean" in snap}}


def modes_phase(eng, queries, modes: dict, ops, n_buckets: int,
                scan_kernel: str) -> dict:
    """E.1 / E.2: a counted run of each mode on a fresh server (launches:
    2 pool launches and 1 `scan_kernel` launch a bucket, none of the other
    scan kernel); every mode must give sync's items, scores, cache
    counters and blocks touched, bit for bit. Then one long-lived server a
    mode, warmed, serves `queries` in 3 rounds, the modes taking turns
    within a round; q/s is the median of a mode's 3 runs (a fresh server
    would also time its start, such as the drain thread's first CUDA
    calls). Last, `torch.profiler` over one run of sync and one of
    pipelined serving: the device's busy time and idle share of the run
    (the profiler slows the host, so the share is an upper bound)."""
    from repro_torch.serving import make_server

    other = ({"hamming_distances", "streaming_nns"} - {scan_kernel}).pop()
    runs = {mode: run_mode(eng, mode, knobs, queries, ops)
            for mode, knobs in modes.items()}
    servers = {mode: make_server(eng, mode, max_batch=BATCH, **knobs)
               for mode, knobs in modes.items()}
    for server in servers.values():
        server.serve_many(queries[:BATCH + 37])
    walls = {mode: [] for mode in modes}
    pauses = {mode: GcPauses() for mode in modes}
    for _ in range(3):
        for mode, server in servers.items():
            t0 = time.perf_counter()
            with pauses[mode]:
                served = server.serve_many(queries)
            walls[mode].append(time.perf_counter() - t0)
            check(all(s.status == "ok" for s in served),
                  f"{mode}: a timed run's tickets are not all ok")
    for mode, server in servers.items():
        st = server.stats()
        server.close()
        check(st["n_errors"] == 0 and st["last_error"] is None
              and st["n_served"] == 3 * len(queries) + BATCH + 37,
              f"{mode}: timed server served {st['n_served']}, errors "
              f"{st['n_errors']}")
    out = {}
    for mode, run in runs.items():
        lc = run["launches"]
        check(lc["embedding_pool"] == 2 * n_buckets
              and lc[scan_kernel] == n_buckets and lc[other] == 0,
              f"{mode}: launches {lc} for {n_buckets} buckets")
        out[mode] = {"queries_per_s": len(queries)
                     / statistics.median(walls[mode]),
                     "wall_ms": [w * 1e3 for w in walls[mode]],
                     "launches": lc, "stage_ms": run["stage_ms"],
                     "gc": pauses[mode].summary(),
                     "cache_hit_rate": run["stats"]["cache_hit_rate"],
                     "n_batches": run["stats"]["n_batches"],
                     "blocks_touched": run["blocks_touched"]}
    base = runs["sync"]
    for mode, run in runs.items():
        check(np.array_equal(run["items"], base["items"])
              and np.array_equal(run["scores"], base["scores"]),
              f"{mode}: items or scores differ from sync")
        for key in ("cache_hits", "cache_lookups", "n_batches", "n_padded"):
            check(run["stats"][key] == base["stats"][key],
                  f"{mode}: {key} {run['stats'][key]} != sync's "
                  f"{base['stats'][key]}")
        check(run["blocks_touched"] == base["blocks_touched"],
              f"{mode}: blocks touched differ from sync")
    for mode in ("sync", "pipelined"):
        server = make_server(eng, mode, max_batch=BATCH, **modes[mode])
        prof = device_profile(lambda: server.serve_many(queries))
        server.close()
        out[mode]["profile"] = {k: prof[k] for k in (
            "kernels", "device_ms", "wall_ms", "idle_share")}
    return out, base


def check_against_serve(eng, queries, base) -> None:
    """E.1: sync's rows equal `engine.serve` on the same stacked buckets
    (the batcher's own stacking: -1 padding rows, the valid mask)."""
    from repro_torch.serving import make_server

    stacker = make_server(eng, "sync", max_batch=BATCH)
    row = 0
    for lo in range(0, len(queries), BATCH):
        chunk = queries[lo:lo + BATCH]
        bucket = next(b for b in stacker.buckets if b >= len(chunk))
        r = eng.serve(stacker._stack_np(chunk, bucket))
        n = len(chunk)
        check(np.array_equal(r.items[:n].cpu().numpy(),
                             base["items"][row:row + n])
              and np.array_equal(r.topk.scores[:n].cpu().numpy(),
                                 base["scores"][row:row + n]),
              f"sync serving differs from engine.serve (bucket at {lo})")
        row += n
    stacker.close()


def load_phase(eng, pool, rate_qps: float, seed: int) -> dict:
    """E.3: an open-loop `LoadGen` replay into the concurrent front-end
    (warmed first); p50 / p99 of the admitted tickets, shed and errors."""
    from repro_torch.serving import LoadGen, make_server, summarize_trace

    gen = LoadGen(rate_qps=rate_qps, duration_s=LOAD_S, tenants=LOAD_TENANTS,
                  pool_size=LOAD_POOL, zipf_a=1.1, seed=seed)
    server = make_server(eng, "concurrent", max_batch=BATCH,
                         tenants=LOAD_TENANTS, depth=2)
    server.serve_many(pool[:BATCH + 37])
    server.take_trace()
    t0 = time.perf_counter()
    with GcPauses() as pauses:
        replay = gen.replay(server, pool)
        submit_s = time.perf_counter() - t0
        server.flush()
    trace = server.take_trace()
    st = server.stats()
    server.close()
    s = summarize_trace(trace, gen.duration_s)
    n_err = sum(v["n_errors"] for v in s.per_tenant.values())
    check(n_err == 0 and st["n_errors"] == 0 and st["last_error"] is None,
          f"load replay: {n_err} error tickets, last error "
          f"{st['last_error']}")
    check(len(trace) == len(replay), "load replay lost tickets")
    return {"offered_qps": s.offered_qps, "achieved_qps": s.achieved_qps,
            "p50_ms": s.p50_ms, "p99_ms": s.p99_ms,
            "n_submitted": len(replay),
            "n_shed": sum(v["n_shed"] for v in s.per_tenant.values()),
            "n_errors": n_err, "shed_frac": s.shed_frac,
            "replay_submit_s": submit_s, "rate_qps": rate_qps,
            "duration_s": gen.duration_s, "tenants": LOAD_TENANTS,
            "pool_size": LOAD_POOL, "n_batches": st["n_batches"],
            "gc": pauses.summary()}


def cost_and_hit_rate(eng, seed: int) -> dict:
    """E.4: `ServeResult.cost` equals the port's cost model at the
    engine's candidate count; `hit_rate` in the paper's three modes on the
    synthetic MovieLens set, with the kernels and with the plain versions
    (the same hit counts). Random weights: HR@10 says nothing of
    accuracy."""
    from repro_torch.core import cost_model as cm
    from repro_torch.data.synthetic import make_movielens
    from repro_torch.serving import hit_rate

    e2e = cm.end_to_end_movielens(n_candidates=eng.n_candidates)
    want = cm.OpCost(latency_ns=e2e["imars_latency_us"] * 1e3,
                     energy_pj=e2e["imars_energy_uj"] * 1e6)
    data = make_movielens(n_items=eng.item_table_q.values.shape[0],
                          seed=seed)
    r = eng.serve({**{k: v[:BATCH] for k, v in data.user_feats.items()},
                   "history": data.histories[:BATCH],
                   "genre": data.genres[:BATCH]})
    check(r.cost == want and r.cost == eng.query_cost(),
          f"ServeResult.cost {r.cost} != the cost model's {want}")
    out = {"cost_model": {"latency_us": r.cost.latency_us,
                          "energy_uj": r.cost.energy_uj,
                          "imars_qps": e2e["imars_qps"],
                          "gpu_paper_qps": e2e["gpu_qps"],
                          "latency_speedup": e2e["latency_speedup"],
                          "energy_reduction": e2e["energy_reduction"]},
           "n_users": data.n_users, "hr10": {}}
    for mode in ("fp32", "int8", "lsh"):
        hr = hit_rate(eng, data, mode=mode)
        with plain_versions():
            hr_plain = hit_rate(eng, data, mode=mode)
        check(round(hr * data.n_users) == round(hr_plain * data.n_users),
              f"hit_rate {mode}: {hr} with the kernels, {hr_plain} plain")
        out["hr10"][mode] = hr
    return out


def mode_summary(mode: str, v: dict) -> str:
    """One mode's figures for a phase E line."""
    text = (f"{mode} {v['queries_per_s']:.0f} q/s (runs "
            f"{[round(w, 2) for w in v['wall_ms']]} ms; ms a bucket "
            f"{ {s: round(x, 3) for s, x in v['stage_ms'].items()} }; "
            f"full GCs {v['gc']['gen2_collections']}, longest "
            f"{v['gc']['gen2_max_ms']:.1f} ms")
    if "profile" in v:
        p = v["profile"]
        text += (f"; profiled run: {p['device_ms']:.3f} ms on the card in "
                 f"{p['wall_ms']:.1f} ms, idle share {p['idle_share']:.3f}")
    return text + ")"


def serving_phase(eng_a, eng_b, inputs, seed: int, ops, card: str) -> dict:
    """Phase E: the front-ends over phase A's and phase B's engines."""
    rng = np.random.default_rng(seed + 4)
    qa = split_queries(make_batch(rng, inputs["A"]["cfg"], N_QUERIES_E1))
    qb = split_queries(make_batch(rng, inputs["B"]["cfg"], N_QUERIES_E2))
    pool = split_queries(make_batch(rng, inputs["A"]["cfg"], LOAD_POOL))
    e = {}
    # E.1: sync, pipelined and concurrent on the dense plan. The concurrent
    # queue (unbounded: a closed-loop stream sheds nothing) is staged before
    # its drain starts, so its buckets are sync's and its bits must be too
    n_a = -(-N_QUERIES_E1 // BATCH)
    e["E1"], base = modes_phase(
        eng_a, qa, {"sync": {}, "pipelined": {"depth": 2},
                    "concurrent": {"tenants": 2, "depth": 2,
                                   "queue_depth": None,
                                   "autostart": False}},
        ops, n_a, "hamming_distances")
    check_against_serve(eng_a, qa, base)
    print(f"phase E.1 (make_server on phase A's engine, {N_QUERIES_E1} "
          f"single-user queries, {n_a} buckets; {card}): " + ", ".join(
              mode_summary(m, v) for m, v in e["E1"].items())
          + f"; bit-equal across modes and to engine.serve, launches "
          f"{e['E1']['sync']['launches']}, cache hit rate "
          f"{e['E1']['sync']['cache_hit_rate']:.4f}", flush=True)
    # E.2: sync and pipelined on the 1M-item pruned streaming plan
    n_b = -(-N_QUERIES_E2 // BATCH)
    e["E2"], _ = modes_phase(eng_b, qb, {"sync": {},
                                         "pipelined": {"depth": 2}},
                             ops, n_b, "streaming_nns")
    check(e["E2"]["sync"]["blocks_touched"] > 0,
          "phase E.2: no blocks touched in the registry")
    print(f"phase E.2 (make_server on phase B's engine, {N_QUERIES_E2} "
          f"queries, pruned streaming; {card}): " + ", ".join(
              mode_summary(m, v) for m, v in e["E2"].items())
          + f"; bit-equal, blocks touched {e['E2']['sync']['blocks_touched']}"
          f", launches {e['E2']['pipelined']['launches']}", flush=True)
    # E.3: open-loop load at half the pipelined rate of E.1, then at a
    # tenth of it (a second point of the latency-vs-load curve)
    e["E3"] = {}
    for frac in LOAD_FRACS:
        ld = load_phase(eng_a, pool,
                        frac * e["E1"]["pipelined"]["queries_per_s"],
                        seed + 5)
        e["E3"][f"{frac:g} of pipelined"] = ld
        print(f"phase E.3 (LoadGen into the concurrent front-end, "
              f"{LOAD_TENANTS} tenants, zipf 1.1, pool {LOAD_POOL}, "
              f"{LOAD_S} s at {ld['rate_qps']:.0f} q/s offered, {frac:g} "
              f"of E.1's pipelined q/s; {card}): p50 {ld['p50_ms']:.3f} "
              f"ms, p99 {ld['p99_ms']:.3f} ms, achieved "
              f"{ld['achieved_qps']:.0f} q/s, submitted "
              f"{ld['n_submitted']}, shed {ld['n_shed']}, errors "
              f"{ld['n_errors']}; full GCs {ld['gc']['gen2_collections']},"
              f" longest {ld['gc']['gen2_max_ms']:.1f} ms, total "
              f"{ld['gc']['gen2_total_ms']:.1f} ms", flush=True)
    # E.4: the paper's cost model and hit_rate
    e["E4"] = cost_and_hit_rate(eng_a, seed)
    c = e["E4"]["cost_model"]
    print(f"phase E.4: ServeResult.cost == the paper's analytic FeFET model "
          f"(not measured): {c['latency_us']:.3f} us and "
          f"{c['energy_uj']:.4f} uJ a query, {c['imars_qps']:.0f} q/s "
          f"modelled against the paper's GPU baseline "
          f"{c['gpu_paper_qps']:.0f} q/s; HR@10 on the synthetic MovieLens "
          f"set ({e['E4']['n_users']} users), random weights, equal with "
          f"the plain versions: {e['E4']['hr10']} ({card})", flush=True)
    e["launches"] = {k: sum(v["launches"][k] for ph in ("E1", "E2")
                            for v in e[ph].values())
                     for k in e["E1"]["sync"]["launches"]}
    return e


# ---------------------------------------------------------------------------
# phase F: the live catalog and the tiered out-of-core catalog
# ---------------------------------------------------------------------------
def same_serve(got, want, what: str) -> None:
    """Two ServeResults equal bit for bit: items, scores, the NNS
    (blocks touched included) and the cache counters."""
    for f in ("indices", "distances", "counts", "blocks_touched"):
        a, b = getattr(got.nns, f), getattr(want.nns, f)
        check((a is None and b is None) or (
            a is not None and b is not None and torch.equal(a, b)),
            f"{what}: NNS {f} differ")
    check(torch.equal(got.items, want.items), f"{what}: items differ")
    check(torch.equal(got.topk.scores, want.topk.scores),
          f"{what}: scores differ")
    check(got.stats.as_dict() == want.stats.as_dict(),
          f"{what}: cache counters {got.stats.as_dict()} != "
          f"{want.stats.as_dict()}")


def counted_serves(serve, batches, ops):
    """`serve` over `batches`, the kernels' launches counted over exactly
    that loop -> (results, launches, wall ms a batch)."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    results = [serve(b) for b in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return results, ops.launch_counts(), wall / len(batches) * 1e3


def check_launches(launches: dict, want: dict, n: int, what: str) -> None:
    for name, per in want.items():
        check(launches[name] == per * n,
              f"{what}: launches {launches} for {n} batches (want {per} "
              f"{name} a batch)")


def serve_ms(engine, batches, reps: int = 5) -> float:
    """Wall ms a batch of `engine.serve` over `batches`, warmed."""
    for b in batches:
        engine.serve(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for b in batches:
            engine.serve(b)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / (reps * len(batches)) * 1e3


def churn_rounds(rng, n: int, d: int, hot: np.ndarray) -> list:
    """F.1's seeded update batches: (name, [update kwargs, ...], retired
    new id to put in the histories or None)."""
    def rows(m):
        return (0.05 * rng.standard_normal((m, d))).astype(np.float32)

    new = np.arange(n, n + 64)
    cold = np.setdiff1d(np.arange(n), hot)
    re = np.r_[hot[:16], rng.choice(cold, 48, replace=False)]
    dels = np.r_[rng.choice(np.setdiff1d(cold, re), 40, replace=False),
                 new[:8]]
    back = int(re[-1])
    fill = np.arange(n + 64, n + 64 + 1000)
    return [
        ("upsert of 64 new ids past n",
         [dict(upsert_ids=new, upsert_rows=rows(64))], None),
        ("re-embed of 16 hot-cached and 48 cold rows",
         [dict(upsert_ids=re, upsert_rows=rows(len(re)))], None),
        ("delete of 40 base and 8 new ids",
         [dict(delete_ids=dels)], int(new[0])),
        ("delete and re-add of one id",
         [dict(delete_ids=[back]), dict(upsert_ids=[back],
                                        upsert_rows=rows(1))], int(new[0])),
        ("1000 new ids: the delta fills, a compaction is forced",
         [dict(upsert_ids=fill, upsert_rows=rows(len(fill)))], int(new[1])),
    ]


def with_retired(batches, gid):
    """The batches with a retired new id as every history's first item."""
    if gid is None:
        return batches
    out = []
    for b in batches:
        b = dict(b)
        b["history"] = b["history"].copy()
        b["history"][:, 0] = gid
        out.append(b)
    return out


def live_dense_phase(eng_a, batches, seed: int, ops) -> dict:
    """F.1: the churn through `LiveCatalog` at phase A's 3,000 items, each
    update batch's serving bit-equal to `rebuild_reference()` on the card;
    then the same churn through sync and pipelined front-ends attached to
    one catalog (equal results)."""
    from repro_torch.serving import LiveCatalog, make_server

    rng = np.random.default_rng(seed + 6)
    n, d = eng_a.item_table_q.values.shape
    rounds = churn_rounds(rng, n, d, eng_a.item_hot.hot_ids.cpu().numpy())
    cat = LiveCatalog(eng_a, delta_capacity=1024)
    out = {"rounds": [], "launches": None}
    total = None
    for name, updates, retired in rounds:
        epoch = cat.epoch
        for u in updates:
            cat.apply_updates(**u)
        bs = with_retired(batches, retired)
        live, lc, _ = counted_serves(cat.engine.serve, bs, ops)
        check_launches(lc, {"embedding_pool": 2, "hamming_distances": 2,
                            "streaming_nns": 0}, len(bs), f"F.1 {name}")
        total = lc if total is None else {k: total[k] + lc[k] for k in lc}
        ref = cat.rebuild_reference()
        for i, (g, b) in enumerate(zip(live, bs)):
            same_serve(g, ref.serve(b), f"F.1 {name}, batch {i}")
        out["rounds"].append({"update": name, "epoch": cat.epoch,
                              "pending": cat.n_pending,
                              "n_items": cat.n_items,
                              "cache": live[0].stats.as_dict()})
        if name.startswith("1000"):
            check(cat.epoch == epoch + 1 and cat.n_pending == 1000,
                  f"F.1: the full delta forced no compaction (epoch "
                  f"{cat.epoch}, pending {cat.n_pending})")
    out["launches"] = total
    out["n_batches"] = len(rounds) * len(batches)
    out["n_items_base"] = n
    out["forced_compact_s"] = cat.last_compact_s
    out["pending"] = cat.n_pending
    out["frozen_ms"] = serve_ms(eng_a, batches)
    out["live_ms"] = serve_ms(cat.engine, batches)

    # the same churn through sync and pipelined servers on one catalog
    rng = np.random.default_rng(seed + 6)
    rounds = churn_rounds(rng, n, d, eng_a.item_hot.hot_ids.cpu().numpy())
    cat2 = LiveCatalog(eng_a, delta_capacity=1024)
    servers = {m: make_server(cat2.engine, m, max_batch=BATCH, **k)
               for m, k in (("sync", {}), ("pipelined", {"depth": 2}))}
    for server in servers.values():
        cat2.attach(server)
    pipe_launches = None
    for name, updates, retired in rounds:
        for u in updates:
            cat2.apply_updates(**u)
        queries = [q for b in with_retired(batches, retired)
                   for q in split_queries(b)]
        got = {}
        for mode, server in servers.items():
            torch.cuda.synchronize()
            ops.reset_launches()
            got[mode] = server.serve_many(queries)
            torch.cuda.synchronize()
            lc = ops.launch_counts()
            check_launches(lc, {"embedding_pool": 2, "hamming_distances": 2,
                                "streaming_nns": 0}, len(batches),
                           f"F.1 {mode} server, {name}")
            if mode == "pipelined":
                pipe_launches = lc if pipe_launches is None else {
                    k: pipe_launches[k] + lc[k] for k in lc}
        for a, b in zip(got["pipelined"], got["sync"]):
            check(a.status == b.status == "ok"
                  and np.array_equal(a.items, b.items)
                  and np.array_equal(a.scores, b.scores),
                  f"F.1 pipelined differs from sync after {name}")
    st = {m: s.stats() for m, s in servers.items()}
    for server in servers.values():
        server.close()
    for key in ("cache_hits", "cache_lookups", "n_served"):
        check(st["pipelined"][key] == st["sync"][key],
              f"F.1 pipelined {key} differs from sync")
    check(st["sync"]["n_errors"] == 0 and st["pipelined"]["n_errors"] == 0,
          "F.1 servers reported errors")
    out["pipelined_launches"] = pipe_launches
    out["engine"] = cat.engine
    return out


def live_stream_phase(eng_b, batches, seed: int, ops) -> dict:
    """F.2: 1% of phase B's 1,048,576 rows tombstoned and 1,024 rows
    re-embedded; serving bit-equal to `rebuild_reference()` (blocks touched
    included), one masked-pruned streaming launch a batch; then the
    compaction, timed."""
    from repro_torch.serving import LiveCatalog

    rng = np.random.default_rng(seed + 7)
    n, d = eng_b.item_table_q.values.shape
    hot = eng_b.item_hot.hot_ids.cpu().numpy()
    dels = rng.choice(n, n // 100, replace=False)
    cand = np.setdiff1d(np.arange(n), np.r_[dels, hot])
    ups = np.r_[hot[:16], rng.choice(cand, 1024 - 16, replace=False)]
    cat = LiveCatalog(eng_b, delta_capacity=1024)
    t0 = time.perf_counter()
    cat.delete(dels)
    cat.upsert(ups, (0.05 * rng.standard_normal((len(ups), d))
                     ).astype(np.float32))
    update_s = time.perf_counter() - t0
    live, lc, _ = counted_serves(cat.engine.serve, batches, ops)
    check_launches(lc, {"embedding_pool": 2, "hamming_distances": 1,
                        "streaming_nns": 1}, len(batches), "F.2")
    ref = cat.rebuild_reference()
    for i, (g, b) in enumerate(zip(live, batches)):
        same_serve(g, ref.serve(b), f"F.2 batch {i}")
    del ref
    out = {"launches": lc, "update_s": update_s, "pending": cat.n_pending,
           "n_items": cat.n_items,
           "blocks_touched_mean": float(
               live[0].nns.blocks_touched.float().mean()),
           "frozen_ms": serve_ms(eng_b, batches),
           "live_ms": serve_ms(cat.engine, batches)}
    out["compact_s"] = cat.compact()
    out["engine"] = cat.engine
    return out


def tiered_phase(eng, batches, freqs, seed: int, ops) -> dict:
    """F.3: F.2's compacted catalog spilled to a base shard in a temporary
    directory (removed at the end) and served through `TieredCatalog`:
    bit-equal to `to_ram_engine().serve`, 4 streaming launches a batch
    (out of core, chunks of 2^18 rows), 1 Hamming and 2 pool launches;
    churn, compaction and a check against `rebuild_reference()`; snapshot
    and restore serving the same bits."""

    from repro_torch.core.lsh import lsh_signature
    from repro_torch.core.nns import out_of_core_nns
    from repro_torch.serving import TieredCatalog

    rng = np.random.default_rng(seed + 8)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tiered_")
    try:
        t0 = time.perf_counter()
        tier = TieredCatalog.from_engine(eng, os.path.join(tmp, "shard"),
                                         pool_rows=4096,
                                         item_freqs=np.array(freqs, np.int64))
        open_s = time.perf_counter() - t0
        ram = tier.to_ram_engine()
        tier.serve(batches[0])  # warm-up: pinned buffers, page cache
        staged = []

        def serve(b):
            r = tier.serve(b)
            staged.append(tier.last_staged_bytes)
            return r

        got, lc, ms = counted_serves(serve, batches, ops)
        check_launches(lc, {"embedding_pool": 2, "hamming_distances": 1,
                            "streaming_nns": 4}, len(batches), "F.3")
        for i, (g, b) in enumerate(zip(got, batches)):
            same_serve(g, ram.serve(b), f"F.3 batch {i} vs to_ram_engine")
        # the out-of-core scan alone, on the first batch's query signatures
        q = lsh_signature(ram.user_embedding(batches[0]), ram.lsh_proj)

        def scan():
            return out_of_core_nns(q, tier.base.sigs, ram.radius,
                                   ram.n_candidates, db_mask=tier.alive,
                                   summary=tier.summary)

        scan()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            scan()
        torch.cuda.synchronize()
        scan_ms = (time.perf_counter() - t0) / 3 * 1e3
        # the host's byte overlays of the first batch (history, then the
        # candidates), staged on the card
        cand = got[0].nns.indices.cpu().numpy()
        t0 = time.perf_counter()
        for _ in range(3):
            tier._build_overlay(batches[0]["history"])
            tier._build_overlay(cand)
        torch.cuda.synchronize()
        overlay_ms = (time.perf_counter() - t0) / 3 * 1e3
        out = {"launches": lc, "ms_per_batch": ms, "scan_ms": scan_ms,
               "overlay_ms": overlay_ms,
               "open_s": open_s, "staged_bytes": staged[-1],
               "resident_bytes": tier.resident_bytes(),
               "stats": tier.stats()}
        del ram

        # churn: pool and hot rows re-embedded, rows deleted
        n, d = tier.base.n, tier.base.d
        ups = np.r_[tier.pool_ids[:32], rng.choice(n, 96, replace=False)]
        ups = np.unique(ups)
        tier.upsert(ups, (0.05 * rng.standard_normal((len(ups), d))
                          ).astype(np.float32))
        tier.delete(rng.choice(np.setdiff1d(np.arange(n), ups), 64,
                               replace=False))
        ram = tier.to_ram_engine()
        same_serve(tier.serve(batches[0]), ram.serve(batches[0]),
                   "F.3 after churn vs to_ram_engine")
        del ram
        t0 = time.perf_counter()
        tier.compact()
        out["compact_s"] = time.perf_counter() - t0
        ref = tier.rebuild_reference()
        same_serve(tier.serve(batches[1]), ref.serve(batches[1]),
                   "F.3 after compaction vs rebuild_reference")
        del ref
        # snapshot, a change, restore: the snapshot's bits again
        tier.rebalance()
        snap = os.path.join(tmp, "snapshot")
        tier.snapshot(snap)
        want = tier.serve(batches[0])
        tier.delete(tier.pool_ids[:8])
        tier.restore(snap)
        same_serve(tier.serve(batches[0]), want, "F.3 after restore")
        out["epoch"] = tier.epoch
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def catalog_phase(eng_a, eng_b, inputs, seed: int, ops, card: str) -> dict:
    """Phase F: F.1 live dense, F.2 live streaming, F.3 tiered."""
    t0 = time.perf_counter()
    f1 = live_dense_phase(eng_a, inputs["A"]["batches"][:2], seed, ops)
    f2 = live_stream_phase(eng_b, inputs["B"]["batches"][:2], seed, ops)
    f3 = tiered_phase(f2.pop("engine"), inputs["B"]["batches"][:2],
                      inputs["B"]["freqs"], seed, ops)
    f = {"F1": f1, "F2": f2, "F3": f3, "seconds": time.perf_counter() - t0}
    f["live_engine"] = f1.pop("engine")
    f["launches"] = {k: f1["launches"][k] + f1["pipelined_launches"][k]
                     + f2["launches"][k] + f3["launches"][k]
                     for k in f1["launches"]}
    print(f"phase F.1 (LiveCatalog on phase A's {f1['n_items_base']} "
          f"items, dense; "
          f"{card}): {len(f1['rounds'])} update rounds, each bit-equal to "
          f"rebuild_reference() served on the card (items, scores, NNS, "
          f"cache counters), a retired new id in the histories, the full "
          f"delta forced a compaction ({f1['forced_compact_s']:.4f} s); "
          f"pipelined == sync across the churn; launches a live batch "
          f"{ {k: v // f1['n_batches'] for k, v in f1['launches'].items()} }; "
          f"serve {f1['frozen_ms']:.3f} ms a batch frozen, "
          f"{f1['live_ms']:.3f} ms live ({f1['pending']} pending rows)",
          flush=True)
    print(f"phase F.2 (LiveCatalog on phase B's "
          f"{eng_b.item_table_q.values.shape[0]} items, pruned "
          f"streaming; {card}): 1% tombstoned and 1024 rows re-embedded in "
          f"{f2['update_s']:.3f} s, bit-equal to rebuild_reference() "
          f"(blocks touched {f2['blocks_touched_mean']:.1f} a query), "
          f"launches {f2['launches']} for 2 batches; serve "
          f"{f2['frozen_ms']:.3f} ms a batch frozen, {f2['live_ms']:.3f} ms "
          f"live; compaction {f2['compact_s']:.3f} s", flush=True)
    print(f"phase F.3 (TieredCatalog over F.2's compacted catalog, pool "
          f"4096 rows, 128 hot; {card}): bit-equal to to_ram_engine(), "
          f"rebuild_reference() after churn and compaction, and after "
          f"snapshot + restore; launches {f3['launches']} for 2 batches; "
          f"{f3['ms_per_batch']:.3f} ms a batch, out-of-core scan "
          f"{f3['scan_ms']:.3f} ms, host overlays {f3['overlay_ms']:.3f} "
          f"ms, {f3['staged_bytes']} bytes staged a "
          f"batch, resident {f3['resident_bytes']} B, shard write + open "
          f"{f3['open_s']:.3f} s, compaction {f3['compact_s']:.3f} s; "
          f"phase F took {f['seconds']:.1f} s", flush=True)
    return f


# ---------------------------------------------------------------------------
# phase G: training and train-while-serve
# ---------------------------------------------------------------------------
class Killed(Exception):
    """A hard fault of G.5's loop (not one `TrainLoop` retries)."""


def counted(fn, ops):
    """fn() with the kernels' launches counted over exactly that call ->
    (result, launches)."""
    torch.cuda.synchronize()
    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, ops.launch_counts()


def add_counts(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in more.items()}


def timed_steps(step, state, batches):
    """Run `step` over `batches` from `state`, synchronizing after each ->
    (state, losses, host ms a step)."""
    losses, ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, loss = step(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    return state, torch.stack(losses).cpu().tolist(), ms


def step_summary(losses, ms) -> dict:
    return {"first_loss": losses[0], "last_loss": losses[-1],
            "ms_per_step": statistics.median(ms), "steps": len(losses)}


def offline_training(data, cfg, device, seed: int) -> dict:
    """G.1: 400 filtering steps of `make_recsys_train_step` (batch 256),
    then 200 AdamW ranking steps (batch 128, 16 candidates), from
    `init_youtubednn` on a seeded CUDA generator."""
    from repro_torch.data import synthetic
    from repro_torch.distributed import training
    from repro_torch.models import recsys as rs

    gen = torch.Generator(device=device).manual_seed(seed + 3)
    params = rs.init_youtubednn(gen, cfg, device)
    step = training.make_recsys_train_step(cfg)
    state = training.init_recsys_train_state(params, device)
    batches = list(synthetic.movielens_batches(data, G_BATCH, G_FILTER_STEPS))
    state, f_losses, f_ms = timed_steps(step, state, batches)
    check(f_losses[-1] < f_losses[0] - 0.5,
          f"G.1: filtering loss {f_losses[0]:.4f} -> {f_losses[-1]:.4f} did "
          f"not fall by 0.5")
    prof = device_profile(lambda: step(state, batches[0]))
    rank = training.make_loss_step(lambda p, b: rs.ranking_loss(p, cfg, b))
    state, r_losses, r_ms = timed_steps(
        rank, training.init_recsys_train_state(state.params, device),
        synthetic.movielens_rank_batches(data, G_RANK_BATCH, G_CANDS,
                                         G_RANK_STEPS))
    check(all(np.isfinite(r_losses)), "G.1: ranking loss not finite")
    return {"params": state.params,
            "filter": step_summary(f_losses, f_ms),
            "rank": step_summary(r_losses, r_ms),
            "profile": {k: prof[k] for k in ("kernels", "device_ms",
                                             "wall_ms", "idle_share", "top")}}


def accuracy(engine, data, ops) -> dict:
    """G.2: HR@10 over every user in the paper's three configurations,
    with the reference's ordering checks (`tests/test_recsys_pipeline.py`
    `test_accuracy_ordering_fp32_int8_lsh`)."""
    from repro_torch.serving.recsys_engine import hit_rate

    def run():
        return {mode: hit_rate(engine, data, k=10, mode=mode)
                for mode in ("fp32", "int8", "lsh")}

    hr, launches = counted(run, ops)
    chance = 10 / data.n_items
    check(hr["fp32"] > 1.2 * chance,
          f"G.2: HR@10 fp32 {hr['fp32']:.4f} not above 1.2x chance")
    check(abs(hr["fp32"] - hr["int8"]) < 0.02,
          f"G.2: HR@10 int8 {hr['int8']:.4f} vs fp32 {hr['fp32']:.4f}")
    check(hr["lsh"] <= hr["int8"] + 0.01,
          f"G.2: HR@10 lsh {hr['lsh']:.4f} beats int8 {hr['int8']:.4f}")
    return {"hr": hr, "chance": chance, "launches": launches}


def serve_rounds(server, queries, stop) -> tuple[list, list]:
    """Serve `queries` through `server` round after round until `stop()`
    (checked after each round, so at least one runs) -> (q/s of each
    round, tickets)."""
    served, rates = [], []
    while True:
        t0 = time.perf_counter()
        tickets = [server.submit(q) for q in queries]
        served.extend(server.result(t, timeout=WAIT_S) for t in tickets)
        rates.append(len(queries) / (time.perf_counter() - t0))
        if stop():
            break
    return rates, served


def train_while_serve(engine, data, cfg, ops) -> dict:
    """G.3 and G.4: an `OnlineTrainer` over a `LiveCatalog` of `engine`,
    attached to a concurrent front-end, trains on its own thread while the
    front-end serves; shadow checkpoints; a step without a fold."""
    from repro_torch.data import synthetic
    from repro_torch.serving import (
        LiveCatalog,
        OnlineTrainer,
        ShadowHarness,
        make_server,
    )
    from repro_torch.serving.catalog import delta_n_live
    from repro_torch.utils import tree_leaves

    queries = synthetic.serving_queries(
        data, np.arange(G_QUERIES) % data.n_users)
    knobs = dict(max_batch=BATCH, queue_depth=None)
    # the same queries on the frozen engine, rounds of the same size,
    # before and after the training window
    frozen = make_server(engine, "concurrent", **knobs)
    serve_rounds(frozen, queries, lambda: True)  # warm

    def frozen_qps():
        rounds = iter(range(G_FROZEN_ROUNDS - 1))
        return serve_rounds(frozen, queries,
                            lambda: next(rounds, None) is None)[0]

    frozen_before = frozen_qps()

    cat = LiveCatalog(engine, delta_capacity=cfg.n_items)
    server = make_server(cat.engine, "concurrent", **knobs)
    cat.attach(server)
    trainer = OnlineTrainer(cat, cfg, engine.params, fold_every=1,
                            compact_every=4)
    fold_ms, compact_ms = [], []
    for obj, name, sink in ((trainer, "fold", fold_ms),
                            (cat, "compact", compact_ms)):
        setattr(obj, name, timed_call(getattr(obj, name), sink))
    batches = iter(synthetic.movielens_batches(data, G_BATCH, 10_000,
                                               seed=11))
    done, errors = threading.Event(), []

    def train():
        try:
            for _ in range(G_ONLINE_STEPS):
                trainer.step(next(batches))
        except Exception as e:  # re-raised by the check below
            errors.append(e)
        finally:
            done.set()

    def window():
        th = threading.Thread(target=train, daemon=True)
        th.start()
        out = serve_rounds(server, queries, done.is_set)
        th.join(timeout=WAIT_S)
        check(not th.is_alive(), "G.3: the training thread did not end")
        return out

    (rates, served), launches = counted(window, ops)
    frozen_after = frozen_qps()
    frozen.close()
    check(not errors, f"G.3: training thread failed: {errors!r}")
    st = server.stats()
    check(all(s.status == "ok" for s in served) and st["n_errors"] == 0,
          f"G.3: {st['n_errors']} error tickets, statuses "
          f"{sorted({s.status for s in served})}")
    check(trainer.n_folds == G_ONLINE_STEPS and cat.epoch >= 3,
          f"G.3: {trainer.n_folds} folds, epoch {cat.epoch}")
    nb = st["n_batches"]
    check(nb > 0 and launches["embedding_pool"] == 2 * nb
          and launches["hamming_distances"] == 2 * nb
          and launches["streaming_nns"] == 0,
          f"G.3: launches {launches} for {nb} buckets (want 2 pool and 2 "
          f"Hamming a bucket: base and delta scans)")
    online = trainer.stats()

    # shadow checkpoints: now, and after 10 more steps, twice
    shadow = ShadowHarness(trainer, data, k=10, mode="lsh")

    def checkpoints():
        recs = [shadow.checkpoint()]
        for _ in range(2):
            for _ in range(10):
                trainer.step(next(batches))
            recs.append(shadow.checkpoint())
        return recs

    recs, shadow_launches = counted(checkpoints, ops)
    for rec in recs:
        check(rec.gap == 0.0 and rec.agree_frac == 1.0,
              f"G.3: shadow checkpoint at step {rec.step}: gap {rec.gap}, "
              f"agreement {rec.agree_frac}")

    # G.4: one step without a fold leaves what is served as it was
    def aliasing():
        sync = make_server(cat.engine, "sync", max_batch=BATCH)
        published = cat.engine
        kept = [t.clone() for t in tree_leaves(published.params)]
        before = sync.serve_many(queries)
        trainer.fold_every = 0
        trainer.step(next(batches))
        after = sync.serve_many(queries)
        sync.close()
        check(cat.engine is published
              and all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(published.params), kept))
              and all(np.array_equal(a.items, b.items)
                      and np.array_equal(a.scores, b.scores)
                      for a, b in zip(after, before)),
              "G.4: a step without a fold changed what is served")

    _, alias_launches = counted(aliasing, ops)
    server.close()
    out = {"served": len(served), "rounds_training": rates,
            "rounds_frozen": [frozen_before, frozen_after],
            "qps_training": statistics.median(rates),
            "qps_frozen": [statistics.median(frozen_before),
                           statistics.median(frozen_after)],
            "buckets": nb, "launches_serving": launches,
            "launches": add_counts(add_counts(launches, shadow_launches),
                                   alias_launches),
            "staleness_ms_mean": online["staleness_ms_mean"],
            "staleness_ms_p95": online["staleness_ms_p95"],
            "fold_ms": statistics.median(fold_ms), "n_folds_timed":
            len(fold_ms), "compact_ms": statistics.median(compact_ms),
            "n_compactions": len(compact_ms), "epoch": cat.epoch,
            "rows_folded": online["rows_folded"],
            "shadow": [rec._asdict() for rec in recs],
            "last_loss": online["last_loss"]}

    # for phase C: the two states the live engine serves in under
    # full-softmax folds, its 3,000-slot delta empty (just compacted) and
    # full (every row re-embedded, its base row tombstoned), and a bucket
    # of the queries served (six padding rows, as in a tail bucket)
    cat.compact()
    empty = cat.engine
    trainer.compact_every = 0
    trainer.fold()
    full = cat.engine
    check(delta_n_live(empty.delta) == 0
          and delta_n_live(full.delta) == cfg.n_items == full.delta.capacity,
          "G.3: the delta is not empty after a compaction and full after a "
          "fold")
    out["pool_check"] = {
        "engines": {"online_empty_": empty, "online_full_": full},
        "batch": stack_queries(queries[:BATCH - 6], BATCH)}
    return out


def stack_queries(queries: list[dict], bucket: int) -> dict:
    """Single-user queries as one padded bucket (the batcher's layout:
    padding rows all -1, `valid` marking the real ones)."""
    n = len(queries)
    batch = {k: np.full((bucket, *np.shape(v)), -1, np.int32)
             for k, v in queries[0].items()}
    for k in batch:
        batch[k][:n] = np.stack([np.asarray(q[k], np.int32)
                                 for q in queries])
    batch["valid"] = np.arange(bucket) < n
    return batch


def timed_call(fn, sink: list):
    """`fn` that appends its wall ms (synchronized) to `sink`."""
    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        return out

    return wrapped


def restart(params, data, cfg, device) -> dict:
    """G.5: a `TrainLoop` of 10 filtering steps checkpointing every 5 (the
    straggler check off) stops on a hard fault at step 7; the resume from
    step 5 ends bit-equal to an uninterrupted run."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import synthetic
    from repro_torch.distributed import fault_tolerance as ft
    from repro_torch.distributed import training
    from repro_torch.utils import tree_leaves, tree_map

    step = training.make_recsys_train_step(cfg)

    def loop_step(state, batch):
        state, loss = step(state, batch)
        return state, {"loss": loss}

    def fresh():
        return training.init_recsys_train_state(
            tree_map(torch.clone, params), device)

    def leaves(s):
        return tree_leaves([s.params, s.opt.mu, s.opt.nu, s.opt.count,
                            s.step])

    policy = ft.FaultPolicy(checkpoint_every=5,
                            straggler_factor=float("inf"))
    batches = list(synthetic.movielens_batches(data, G_BATCH, 10, seed=12))
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_g5_"))
    try:
        t0 = time.perf_counter()
        ref, _ = ft.TrainLoop(loop_step, Checkpointer(tmp / "ref"),
                              policy).run(fresh(), iter(batches), 10)

        def bomb(i):
            if i == 7:
                raise Killed(f"hard fault at step {i}")

        try:
            ft.TrainLoop(loop_step, Checkpointer(tmp / "crash"), policy,
                         fault_hook=bomb).run(fresh(), iter(batches), 10)
            fail("G.5: the fault at step 7 did not stop the loop")
        except Killed:
            pass
        loop = ft.TrainLoop(loop_step, Checkpointer(tmp / "crash"), policy)
        state, start = loop.resume_or_init(fresh)
        check(start == 5, f"G.5: resumed from step {start}, not 5")
        final, end = loop.run(state, iter(batches[start:]), 10,
                              start_step=start)
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(end == 10 and all(torch.equal(a, b) for a, b in
                            zip(leaves(final), leaves(ref))),
          "G.5: the resumed run is not bit-equal to the uninterrupted one")
    return {"resumed_from": start, "seconds": seconds}


def dlrm_training(device, seed: int) -> dict:
    """G.6: DLRM at its Table I size, 150 AdamW steps on Criteo-like
    batches of 256; the loss must fall by 0.05."""
    from repro_torch.data import synthetic
    from repro_torch.distributed import training
    from repro_torch.models import recsys as rs
    from repro_torch.utils import tree_leaves

    cfg = rs.DLRMConfig()
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    params = rs.init_dlrm(gen, cfg, device)
    step = training.make_loss_step(lambda p, b: rs.dlrm_loss(p, cfg, b))
    _, losses, ms = timed_steps(
        step, training.init_recsys_train_state(params, device),
        synthetic.make_criteo_batches(G_BATCH, G_DLRM_STEPS,
                                      cardinality=cfg.cardinality))
    check(losses[-1] < losses[0] - 0.05,
          f"G.6: DLRM loss {losses[0]:.4f} -> {losses[-1]:.4f} did not "
          f"fall by 0.05")
    return {**step_summary(losses, ms),
            "n_params": sum(t.numel() for t in tree_leaves(params))}


def training_phase(proj, seed: int, device, ops, card: str) -> dict:
    """Phase G: training and train-while-serve at full width."""
    from repro_torch.data import synthetic
    from repro_torch.models.recsys import default_youtubednn_config
    from repro_torch.serving import RecSysEngine

    t_start = time.perf_counter()
    cfg = default_youtubednn_config()
    data = synthetic.make_movielens()  # MovieLens-1M's sizes
    check(data.n_items == cfg.n_items and data.n_users == 6040,
          "G: the synthetic set is not MovieLens-1M's size")
    g = {"G1": offline_training(data, cfg, device, seed)}
    params = g["G1"].pop("params")
    freqs = np.bincount(data.histories[data.histories >= 0],
                        minlength=cfg.n_items)
    engine = RecSysEngine.build(params, cfg, lsh_proj=proj,
                                radius=G_RADIUS, n_candidates=G_CANDIDATES,
                                hot_rows=HOT_ROWS, item_freqs=freqs,
                                device=device)
    g["G2"] = accuracy(engine, data, ops)
    g["G3"] = train_while_serve(engine, data, cfg, ops)
    g["G5"] = restart(params, data, cfg, device)
    g["G6"] = dlrm_training(device, seed)
    g["seconds"] = time.perf_counter() - t_start
    g["launches"] = add_counts(g["G2"]["launches"], g["G3"]["launches"])
    for k in ("hamming_distances", "embedding_pool"):
        check(g["launches"][k] > 0, f"G: {k} never launched")
    f, r, p = g["G1"]["filter"], g["G1"]["rank"], g["G1"]["profile"]
    print(f"phase G.1 (YoutubeDNN training at full width, synthetic "
          f"MovieLens-1M; {card}): {f['steps']} filtering steps of "
          f"{G_BATCH}, loss {f['first_loss']:.4f} -> {f['last_loss']:.4f}, "
          f"{f['ms_per_step']:.3f} ms a step; {r['steps']} AdamW ranking "
          f"steps of {G_RANK_BATCH} x {G_CANDS}, loss "
          f"{r['first_loss']:.4f} -> {r['last_loss']:.4f}, "
          f"{r['ms_per_step']:.3f} ms a step; one filtering step profiled: "
          f"{p['kernels']} device events, {p['device_ms']:.3f} ms on the "
          f"card in {p['wall_ms']:.3f} ms (idle share {p['idle_share']}), "
          f"top {p['top'][:3]}", flush=True)
    hr = g["G2"]["hr"]
    print(f"phase G.2 (HR@10 over all {data.n_users} users, radius "
          f"{G_RADIUS}, {G_CANDIDATES} candidates; synthetic data, the "
          f"paper's 26.8 / 26.2 / 20.8% are on real MovieLens-1M; {card}): "
          f"fp32 {hr['fp32']:.4f}, int8 {hr['int8']:.4f}, lsh "
          f"{hr['lsh']:.4f} (chance {g['G2']['chance']:.4f}); launches "
          f"{g['G2']['launches']}", flush=True)
    o = g["G3"]
    print(f"phase G.3 (OnlineTrainer on a LiveCatalog, 3000-slot delta, "
          f"fold every step, compaction every 4 folds, concurrent "
          f"front-end; {card}): {G_ONLINE_STEPS} steps while serving "
          f"{o['served']} queries in {o['buckets']} buckets at "
          f"{o['qps_training']:.0f} q/s (median of "
          f"{len(o['rounds_training'])} rounds of {G_QUERIES}, "
          f"{min(o['rounds_training']):.0f}-{max(o['rounds_training']):.0f};"
          f" frozen engine, {G_FROZEN_ROUNDS} rounds before / after: "
          f"{o['qps_frozen'][0]:.0f} / {o['qps_frozen'][1]:.0f} q/s, "
          f"{min(min(r) for r in o['rounds_frozen']):.0f}-"
          f"{max(max(r) for r in o['rounds_frozen']):.0f}), no error ticket; "
          f"{o['rows_folded']}"
          f" rows folded, {o['fold_ms']:.2f} ms a fold, "
          f"{o['n_compactions']} compactions of {o['compact_ms']:.2f} ms, "
          f"epoch {o['epoch']}; staleness mean "
          f"{o['staleness_ms_mean']:.2f} ms, p95 {o['staleness_ms_p95']:.2f}"
          f" ms; launches while serving {o['launches_serving']}; shadow "
          f"checkpoints at steps {[s['step'] for s in o['shadow']]}: gap "
          f"{[s['gap'] for s in o['shadow']]}, agreement "
          f"{[s['agree_frac'] for s in o['shadow']]}, HR@10 "
          f"{[round(s['hr_live'], 4) for s in o['shadow']]}, "
          f"{[round(s['eval_s'], 3) for s in o['shadow']]} s each", flush=True)
    print(f"phase G.4: a step without a fold left the served bits and "
          f"engine.params unchanged; G.5: TrainLoop resumed from step "
          f"{g['G5']['resumed_from']} after a fault at step 7, bit-equal to "
          f"the uninterrupted run ({g['G5']['seconds']:.2f} s)", flush=True)
    d = g["G6"]
    print(f"phase G.6 (DLRM, Table I: 26 x 28000 x 32, {d['n_params']} "
          f"params; {card}): {d['steps']} AdamW steps of {G_BATCH}, loss "
          f"{d['first_loss']:.4f} -> {d['last_loss']:.4f}, "
          f"{d['ms_per_step']:.3f} ms a step; phase G took "
          f"{g['seconds']:.1f} s", flush=True)
    return g


# ---------------------------------------------------------------------------
# phase H: the multi-GPU RecSys plans at world size 1, and banks on one card
# ---------------------------------------------------------------------------
def mesh_serves(phases: dict, meshes: dict, ops) -> tuple[dict, dict]:
    """H.1: phase A's and B's engines, sharded over each mesh, serve their
    batches bit-equal to the unsharded engine's results (blocks touched
    included), with the same launches -> (record, launches)."""
    rec, total = {}, None
    for name, (eng, batches, local) in phases.items():
        # the unsharded engine's time beside the shardings', in turns
        rec[f"{name}_local_ms"] = [counted_serves(eng.serve, batches,
                                                  ops)[2]]
        for mname, (mesh, axis, qaxis) in meshes.items():
            t0 = time.perf_counter()
            sharded = eng.shard(mesh, axis, query_axis=qaxis)
            torch.cuda.synchronize()
            shard_s = time.perf_counter() - t0
            sharded.serve(batches[0])  # warm-up
            res, lc, ms = counted_serves(sharded.serve, batches, ops)
            check(lc == local["launches"],
                  f"H.1 {name} {mname}: launches {lc} != the local plan's "
                  f"{local['launches']}")
            for i, (g, w) in enumerate(zip(res, local["results"])):
                same_serve(g, w, f"H.1 {name} {mname}, batch {i}")
            rec[f"{name}_{mname}"] = {"ms_per_batch": ms, "shard_s": shard_s,
                                      "rows_held": sharded.item_sigs.shape[0]}
            total = lc if total is None else add_counts(total, lc)
        rec[f"{name}_local_ms"].append(counted_serves(eng.serve, batches,
                                                      ops)[2])
    return rec, total


def mesh_live(eng_a, batches, mesh, seed: int, ops) -> tuple[dict, dict]:
    """H.1: one LiveCatalog update batch and a compaction on phase A's
    engine sharded over the 1 x 1 grid, each serving bit-equal to
    `rebuild_reference()` -> (record, launches)."""
    from repro_torch.serving import LiveCatalog

    rng = np.random.default_rng(seed + 11)
    n, d = eng_a.item_table_q.values.shape
    cat = LiveCatalog(eng_a.shard(mesh, "banks", query_axis="qp"),
                      delta_capacity=64)
    hot = eng_a.item_hot.hot_ids.cpu().numpy()
    ids = np.r_[np.arange(n, n + 16), hot[:4], [10, 20]]
    cat.upsert(ids, rng.standard_normal((len(ids), d)).astype(np.float32))
    cat.delete(np.array([5, 17, n + 3]))
    live, lc, _ = counted_serves(cat.engine.serve, batches, ops)
    ref = cat.rebuild_reference()
    check(ref.nns_mesh is None, "H.1: rebuild_reference() is sharded")
    for i, (g, b) in enumerate(zip(live, batches)):
        same_serve(g, ref.serve(b), f"H.1 live update, batch {i}")
    compact_s = cat.compact()
    check(cat.engine.nns_mesh is mesh and cat.engine.nns_axis == "banks",
          "H.1: the compaction did not re-shard onto the mesh")
    live2, lc2, _ = counted_serves(cat.engine.serve, batches, ops)
    ref = cat.rebuild_reference()
    for i, (g, b) in enumerate(zip(live2, batches)):
        same_serve(g, ref.serve(b), f"H.1 compacted, batch {i}")
    return ({"n_items": cat.n_items, "epoch": cat.epoch,
             "compact_s": compact_s}, add_counts(lc, lc2))


def bank_split(qs, sigs, radius: int, k: int, n_banks: int, summary, ops,
               what: str) -> dict:
    """H.2: `n_banks` banks of `sigs` on one card, no collective: each
    bank's `bank_scan` (its rows, its summary blocks when `summary`), then
    `merge_banks`; bit-equal to the local plan over every row and to the
    same decomposition on the plain versions. -> ms of each bank's scan and
    of the one full-catalog scan."""
    from repro_torch.core import nns
    from repro_torch.utils import bank_slice

    n = sigs.shape[0]
    banks = [bank_slice(sigs, n_banks, b) for b in range(n_banks)]
    per = banks[0].shape[0]
    sums = [None] * n_banks
    if summary is not None:
        nb = per // summary.block_rows
        check(per % summary.block_rows == 0, f"{what}: banks not aligned")
        sums = [nns.BlockSummary(
            *(x[b * nb:(b + 1) * nb] for x in (
                summary.or_sigs, summary.and_sigs, summary.min_pc,
                summary.max_pc, summary.n_alive)),
            block_rows=summary.block_rows) for b in range(n_banks)]

    def scan(b):
        return nns.bank_scan(qs, banks[b], radius, k, bank=b, n_valid=n,
                             summary=sums[b])

    def full():
        return nns.fixed_radius_nns(qs, sigs, radius, k, summary=summary)

    torch.cuda.synchronize()
    ops.reset_launches()
    got = nns.merge_banks([scan(b) for b in range(n_banks)], k)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    with plain_versions():
        plain = nns.merge_banks([scan(b) for b in range(n_banks)], k)
    want = full()
    for f in ("indices", "distances", "counts", "blocks_touched"):
        a, b, p = (getattr(r, f) for r in (got, want, plain))
        check((a is None) == (b is None) == (p is None)
              and (a is None or (torch.equal(a, b) and torch.equal(a, p))),
              f"{what}: merged banks' {f} differ from the local plan or "
              f"the plain versions")
    check(int(got.counts.sum()) > 0, f"{what}: no candidate")
    return {"banks": n_banks, "rows_a_bank": per, "launches": launches,
            "bank_ms": [timed_ms(lambda b=b: scan(b), 10)
                        for b in range(n_banks)],
            "full_ms": timed_ms(full, 10)}


def bank_bags(eng_a, batch, mesh, ops) -> dict:
    """H.2: `sharded_embedding_bag`'s decomposition over 4 banks of phase
    A's item table on one card (each bank's `bank_bag` on the pool kernel,
    then `tree_sum`): bit-equal to the same on the plain versions, within
    1e-6 of the one-table pool; and the NCCL mesh's bag over one bank
    bit-equal to the one-table pool."""
    from repro_torch.core import hierarchy
    from repro_torch.core.quantization import QuantizedTensor
    from repro_torch.utils import bank_slice

    table = eng_a.item_table_q
    ids = eng_a.batch_to_device(batch)["history"]
    tabs = [QuantizedTensor(values=bank_slice(table.values, 4, b),
                            scales=bank_slice(table.scales, 4, b))
            for b in range(4)]

    def bag():
        return hierarchy.tree_sum(torch.stack(
            [hierarchy.bank_bag(tabs[b], ids, b) for b in range(4)]))

    torch.cuda.synchronize()
    ops.reset_launches()
    got = bag()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    with plain_versions():
        plain = bag()
    whole = ops.embedding_pool(table.values, table.scales, ids)
    err = float((got - whole).abs().max())
    check(torch.equal(got, plain), "H.2 bag: the banks' kernel launches "
                                   "differ from the plain versions")
    check(err <= 1e-6, f"H.2 bag: {err} from the one-table pool")
    one = hierarchy.sharded_embedding_bag(mesh, "banks", table, ids)
    check(torch.equal(one, whole), "H.2: the one-bank mesh bag differs")
    return {"launches": launches, "max_abs_err_vs_one_table": err,
            "bank_ms": timed_ms(bag, 10), "one_table_ms": timed_ms(
                lambda: ops.embedding_pool(table.values, table.scales, ids),
                10)}


def mesh_phase(eng_a, eng_b, inputs, a, b, seed: int, ops,
               card: str) -> dict:
    """Phase H: the multi-GPU RecSys plans over NCCL at world size 1
    (H.1) and banks on one card without a collective (H.2)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core.lsh import lsh_signature
    from repro_torch.utils import all_gather_axis, make_mesh

    t_start = time.perf_counter()
    rdv = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"file://{rdv}/rendezvous", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    h = {}
    try:
        meshes = {"banks": (make_mesh((1,), ("banks",)), "banks", None),
                  "qp": (make_mesh((1,), ("qp",)), None, "qp"),
                  "grid": (make_mesh((1, 1), ("qp", "banks")), "banks",
                           "qp")}
        batches_a, batches_b = (inputs["A"]["batches"],
                                inputs["B"]["batches"])
        h["H1"], launches = mesh_serves(
            {"A": (eng_a, batches_a, a), "B": (eng_b, batches_b, b)},
            meshes, ops)
        h["H1"]["live"], lc = mesh_live(eng_a, batches_a[:2],
                                        meshes["grid"][0], seed, ops)
        h["launches"] = add_counts(launches, lc)
        # the collective glue alone: one all-gather of a packed (256, 2K +
        # 1) candidate buffer, wall time a call
        packed = torch.zeros((BATCH, 2 * eng_a.n_candidates + 1),
                             dtype=torch.int32, device=eng_a.device)
        h["H1"]["gather_call_ms"] = call_ms(
            lambda: all_gather_axis(packed, meshes["banks"][0], "banks"), 50)

        qa = lsh_signature(eng_a.user_embedding(batches_a[0]),
                           eng_a.lsh_proj)
        qb = lsh_signature(eng_b.user_embedding(batches_b[0]),
                           eng_b.lsh_proj)
        h["H2"] = {
            "B_4_banks": bank_split(qb, eng_b.item_sigs, eng_b.radius,
                                    eng_b.n_candidates, 4,
                                    eng_b.block_summary, ops,
                                    "H.2 B, 4 banks"),
            **{f"A_{w}_banks": bank_split(
                qa, eng_a.item_sigs, eng_a.radius, eng_a.n_candidates, w,
                None, ops, f"H.2 A, {w} banks") for w in (3, 7)},
            "bag_4_banks": bank_bags(eng_a, batches_a[0],
                                     meshes["banks"][0], ops)}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    h["seconds"] = time.perf_counter() - t_start
    h1 = h["H1"]
    print(f"phase H.1 (NCCL, world size 1; {card}): sharded as banks / qp "
          f"/ 1 x 1 grid, bit-equal to the unsharded engines with the same "
          f"launches; ms a batch of {BATCH}: A "
          + " / ".join(f"{h1['A_' + m]['ms_per_batch']:.3f}" for m in meshes)
          + " (unsharded, before / after: " + " / ".join(
              f"{x:.3f}" for x in h1["A_local_ms"]) + "), B "
          + " / ".join(f"{h1['B_' + m]['ms_per_batch']:.3f}" for m in meshes)
          + " (unsharded " + " / ".join(
              f"{x:.3f}" for x in h1["B_local_ms"]) + "); shard() of B "
          + " / ".join(f"{h1['B_' + m]['shard_s']:.2f}" for m in meshes)
          + f" s; live update and compaction on the grid engine bit-equal "
          f"to rebuild_reference() ({h1['live']['n_items']} items, epoch "
          f"{h1['live']['epoch']}, compaction {h1['live']['compact_s']:.3f}"
          f" s); one NCCL all-gather of a packed candidate buffer "
          f"{h1['gather_call_ms']:.4f} ms a call; launches "
          f"{h['launches']}", flush=True)
    for key, v in h["H2"].items():
        if key.startswith("bag"):
            err = v["max_abs_err_vs_one_table"]
            print(f"phase H.2 bag over 4 banks of A's item table ({card}): "
                  f"bit-equal to the plain versions, {err:.3g} from the "
                  f"one-table pool; "
                  f"{v['bank_ms']:.4f} ms (4 bank launches + tree) vs "
                  f"{v['one_table_ms']:.4f} ms one table; launches "
                  f"{v['launches']}", flush=True)
        else:
            print(f"phase H.2 {key.replace('_', ' ')} of {v['rows_a_bank']} "
                  f"rows ({card}): merged bit-equal to the local plan and "
                  f"the plain versions; ms a bank "
                  f"{[round(x, 4) for x in v['bank_ms']]} vs "
                  f"{v['full_ms']:.4f} ms for the one full-catalog scan; "
                  f"launches {v['launches']}", flush=True)
    print(f"phase H took {h['seconds']:.2f} s", flush=True)
    return h


# ---------------------------------------------------------------------------
# phase D: Qwen3-8B prefill and decode
# ---------------------------------------------------------------------------
def synced_ms(fn):
    """(result, host-clock ms) of `fn`, synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def gap_frac(logits: torch.Tensor, tok: torch.Tensor) -> float:
    """Largest over rows of (max logit - logit of `tok`) / (max - min):
    tests/test_serving.py's criterion passes at <= 0.05."""
    lf = logits.float()
    top = lf.max(-1).values
    spread = top - lf.min(-1).values
    gap = top - lf.gather(-1, tok[:, None].long())[:, 0]
    return float((gap / spread).max())


def device_profile(fn, groups: dict | None = None, n_top: int = 5) -> dict:
    """One run of `fn` under `torch.profiler`: the CUDA kernels it ran,
    their summed device time, the wall time and the device's idle share
    of it, and the `n_top` kernels that took the most time. `groups` (name:
    substrings) also sums the device ms of the kernels whose name holds
    all of a group's substrings, the first group that matches winning;
    the rest go to "other"."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    busy_ms = sum(sum(v) for v in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:n_top]
    out = {"kernels": sum(len(v) for v in by_name.values()),
           "device_ms": busy_ms, "wall_ms": wall_ms,
           "idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
           "top": [(name[:80], len(v), sum(v) / 1e3) for name, v in top]}
    if groups:
        out["groups_ms"] = dict.fromkeys([*groups, "other"], 0.0)
        for name, v in by_name.items():
            hit = next((g for g, subs in groups.items()
                        if all(x in name for x in subs)), "other")
            out["groups_ms"][hit] += sum(v) / 1e3
    return out


def serve_profile(engine, batch, ops) -> dict:
    """One serve step of `batch` under `torch.profiler` (after a warm-up):
    `device_profile`'s kernels, device time and idle share, and the
    launches of the port's kernels in it."""
    engine.serve(batch)
    ops.reset_launches()
    prof = device_profile(lambda: engine.serve(batch))
    prof["launches"] = sum(ops.launch_counts().values())
    return prof


def lm_phase(seed: int, device, ops) -> tuple[dict, dict]:
    """Phase D; returns its record and the int8 operands it drove. After
    the checked runs it profiles a blocked prefill, a flash prefill and a
    decode step (device time and idle share, into the record)."""
    from repro_torch.configs.base import param_count_dense
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.quantization import quantize_rowwise
    from repro_torch.models import transformer as tf
    from repro_torch.serving import engine as lm
    from repro_torch.utils import tree_leaves

    bundle = get_arch(LM_ARCH)
    cfg = bundle.model
    cache_dtype = bundle.parallel.kv_cache_dtype
    check(cache_dtype == "int8", f"{LM_ARCH} cache dtype {cache_dtype}")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed)
    params, init_ms = synced_ms(lambda: tf.init_params(cfg, gen, device))
    # no recursive closure here: its reference cycle would keep the 16 GB
    # of weights alive past the phase, until a full garbage collection
    leaves = tree_leaves(params)
    rec = {"arch": LM_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
           "cache_dtype": cache_dtype, "init_ms": init_ms,
           "weight_bytes": sum(t.numel() * t.element_size()
                               for t in leaves),
           "n_params": sum(t.numel() for t in leaves),
           "param_count_dense": param_count_dense(cfg)}
    check(all(t.device.type == "cuda" for t in leaves), "params off card")
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)).to(device)
    batch = {"tokens": prompt}
    cache_len = LM_PROMPT + LM_GEN + 4  # as launch/serve.py
    engine = lm.LMServingEngine(params, cfg, batch=LM_BATCH,
                                cache_len=cache_len, cache_dtype=cache_dtype)

    # D.1: the entry point as it stands (blocked prefill, no kernel)
    ops.reset_launches()
    res, rec["generate_cold_ms"] = synced_ms(
        lambda: engine.generate(batch, LM_GEN))
    check(set(ops.launch_counts().values()) == {0},
          f"blocked generate launched a kernel: {ops.launch_counts()}")
    toks = res.tokens
    check(toks.shape == (LM_BATCH, LM_GEN), f"tokens {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "generated token out of range")
    res2, gen_ms = synced_ms(lambda: engine.generate(batch, LM_GEN))
    rec.update(generate_ms=gen_ms,
               tokens_per_s=LM_BATCH * LM_GEN / gen_ms * 1e3,
               generate_repeat_equal=bool((res2.tokens == toks).all()))

    # D.2: blocked and flash prefill of the same prompt
    kw = dict(cache_len=cache_len, cache_dtype=cache_dtype)
    pre_b, rec["prefill_blocked_ms"] = synced_ms(
        lambda: lm.prefill(params, cfg, batch, attn_impl="blocked", **kw))
    lb = pre_b.logits[:, -1].float()
    check(bool(torch.isfinite(lb).all()), "blocked prefill logits")
    lm.prefill(params, cfg, batch, attn_impl="flash", **kw)  # warm-up
    ops.reset_launches()
    pre_f, rec["prefill_flash_ms"] = synced_ms(
        lambda: lm.prefill(params, cfg, batch, attn_impl="flash", **kw))
    launches = ops.launch_counts()
    rec["launches"] = launches
    check(launches["flash_attention"] == cfg.n_layers,
          f"flash prefill launches {launches}")
    check(sum(launches.values()) == cfg.n_layers,
          f"flash prefill launched other kernels: {launches}")
    for f in pre_b.caches._fields:
        check(torch.equal(getattr(pre_f.caches, f)[0],
                          getattr(pre_b.caches, f)[0]),
              f"layer 0 cache {f} differs between flash and blocked")
    lf = pre_f.logits[:, -1].float()
    check(bool(torch.isfinite(lf).all()), "flash prefill logits")
    spread = lb.max(-1).values - lb.min(-1).values
    diff = (lf - lb).abs().max(-1).values
    rec["prefill_logit_diff_frac"] = float((diff / spread).max())
    check(rec["prefill_logit_diff_frac"] <= SPREAD_FRAC,
          f"flash vs blocked logits {rec['prefill_logit_diff_frac']:.4f} "
          f"of the spread")
    rec["prefill_gap_frac"] = gap_frac(lb, lf.argmax(-1))
    check(rec["prefill_gap_frac"] <= SPREAD_FRAC,
          f"flash greedy token gap {rec['prefill_gap_frac']:.4f}")
    rec["prefill_argmax_equal"] = bool(
        (lf.argmax(-1) == lb.argmax(-1)).all())

    # D.3: teacher-forced decode from the flash prefill's cache
    tok = torch.from_numpy(toks).to(device)
    caches, step_ms, gaps = pre_f.caches, [], []
    for t in range(LM_GEN - 1):
        out, ms = synced_ms(lambda: lm.decode_step(
            params, cfg, {"tokens": tok[:, t:t + 1]}, caches, LM_PROMPT + t))
        caches = out.caches
        logits = out.logits[:, -1]
        check(bool(torch.isfinite(logits).all()), f"decode {t} logits")
        gaps.append(gap_frac(logits, tok[:, t + 1]))
        check(gaps[-1] <= SPREAD_FRAC, f"decode {t}: the generated token "
              f"is {gaps[-1]:.4f} of the spread below the max")
        step_ms.append(ms)
    rec.update(decode_ms_per_step=sum(step_ms) / len(step_ms),
               decode_ms_steps=step_ms, decode_gap_frac_max=max(gaps))
    step = LM_PROMPT + LM_GEN - 1  # a cache row not written yet
    rec["profile"] = {
        "prefill_blocked": device_profile(lambda: lm.prefill(
            params, cfg, batch, attn_impl="blocked", **kw)),
        "prefill_flash": device_profile(lambda: lm.prefill(
            params, cfg, batch, attn_impl="flash", **kw)),
        "decode_step": device_profile(lambda: lm.decode_step(
            params, cfg, {"tokens": tok[:, -1:]}, caches, step))}

    # D.4: the public int8 matmul op, at kernel_bench's shape and at the
    # MLP up-projection of the prompt's tokens
    xs_rng = np.random.default_rng(seed + 3)
    small = (torch.from_numpy(xs_rng.integers(-127, 128, (256, 512))
                              .astype(np.int8)).to(device),
             torch.from_numpy(xs_rng.integers(-127, 128, (512, 512))
                              .astype(np.int8)).to(device),
             torch.ones((256, 1), device=device),
             torch.ones((1, 512), device=device))
    hidden = pre_f.hidden.reshape(-1, cfg.d_model)
    w = params["layers"]["mlp"]["wi"]["w"][cfg.n_layers - 1]
    xq = quantize_rowwise(hidden.float())  # per token
    wq = quantize_rowwise(w.float().T)  # per output column
    big = (xq.values, wq.values.T.contiguous(), xq.scales, wq.scales.T)
    ops.reset_launches()
    y_small = ops.int8_matmul(*small)
    y = ops.int8_matmul(*big)
    torch.cuda.synchronize()
    rec["int8_launches"] = ops.launch_counts()["int8_matmul"]
    check(rec["int8_launches"] == 2, f"int8 launches {ops.launch_counts()}")
    check(bool(torch.isfinite(y_small).all()), "int8 small output")
    want = hidden.float() @ w.float()
    rec["int8_rel_err_vs_bf16"] = float((y - want).norm() / want.norm())
    check(rec["int8_rel_err_vs_bf16"] < 0.05,
          f"int8 up-projection {rec['int8_rel_err_vs_bf16']:.4f} from bf16")
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return rec, {"small": small, "big": big}


# ---------------------------------------------------------------------------
# phase I: LM training on the card
# ---------------------------------------------------------------------------
def bits_digest(t: torch.Tensor) -> tuple[int, int]:
    """An exact digest of a tensor's bits: the sum and the sum of squares
    of its elements' bit patterns as int64 (wrapping), a slab at a time.
    Integer sums do not depend on their order."""
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    flat = t.reshape(-1).view(view[t.element_size()])
    total = torch.zeros(2, dtype=torch.int64, device=t.device)
    for lo in range(0, flat.numel(), 1 << 26):
        c = flat[lo:lo + (1 << 26)].long()
        total += torch.stack([c.sum(), (c * c).sum()])
    return tuple(total.tolist())


def state_tensors(state) -> list:
    """Every tensor of an LM `TrainState`, in a fixed order."""
    from repro_torch.utils import tree_leaves

    moments = [t for q in tree_leaves([state.opt.mu, state.opt.nu])
               for t in ((q.values, q.scales) if hasattr(q, "scales")
                         else (q,))]
    return (tree_leaves(state.params) + moments
            + [state.opt.count, state.step] + tree_leaves(state.err_buf))


def attention_grad_check(device, seed: int) -> dict:
    """I.2: the blocked attention's custom backward at one Qwen3-8B
    layer's shape (B 2, 8 kv heads x 4 queries each, S 2048, hd 128,
    float32) against autograd through the materialized softmax, on the
    card; then the forward + backward timed with TF32 off (as the port
    runs, for parity with the float32 reference) and on."""
    from repro_torch.models.attention import gqa_blocked_attention

    B, R, G, S, hd = I_MB, 8, 4, I_SEQ, 128
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=device)
                     for shape in ((B, R, G, S, hd), (B, R, S, hd),
                                   (B, R, S, hd), (B, R, G, S, hd)))

    def grads(attn):
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        return torch.autograd.grad(attn(qq, kk, vv), (qq, kk, vv), dout)

    def blocked(qq, kk, vv):
        return gqa_blocked_attention(qq, kk, vv, causal=True)

    def materialized(qq, kk, vv):
        s = torch.einsum("brgqd,brkd->brgqk", qq, kk) * hd**-0.5
        causal = torch.ones(S, S, dtype=torch.bool, device=device).triu(1)
        p = torch.softmax(s.masked_fill(causal, float("-inf")), dim=-1)
        return torch.einsum("brgqk,brkd->brgqd", p, vv)

    got, want = grads(blocked), grads(materialized)
    rec = {"shape": f"B={B} R={R} G={G} S={S} hd={hd} f32 causal"}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        rec[f"{name}_max_abs_err"] = err
        rec[f"{name}_max_abs"] = scale
        check(err <= I_ATTN_TOL * scale, f"I.2 {name}: max abs err {err} "
              f"against {I_ATTN_TOL} x {scale}")
    del got, want
    rec["fwd_bwd_ms_tf32_off"] = synced_ms(lambda: grads(blocked))[1]
    rec["materialized_fwd_bwd_ms"] = synced_ms(lambda: grads(materialized))[1]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        grads(blocked)  # warm-up of the TF32 GEMMs
        rec["fwd_bwd_ms_tf32_on"] = synced_ms(lambda: grads(blocked))[1]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return rec


def lm_train_phase(seed: int, device, ops) -> dict:
    """Phase I: the LM train step (`distributed.training.make_train_step`)
    on Qwen3-8B at full width, its depth cut to `I_LAYERS`: I.1 the
    chunked loss against the unchunked one, I.2 the attention backward,
    I.5 two runs of one step from one state, I.3 a stream of steps (times,
    `mfu`, a profiled step, peak memory), I.4 int8 states and gradient
    compression against the float32 run. No port kernel launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.lm_data import (
        PrefetchIterator,
        synthetic_token_stream,
    )
    from repro_torch.distributed import training as tr
    from repro_torch.utils import tree_leaves

    t_phase = time.perf_counter()
    bundle = get_arch(LM_ARCH)
    cfg = bundle.model.with_(n_layers=I_LAYERS)
    pcfg = bundle.parallel.with_(grad_accum={"phase_i": I_ACCUM})
    check(pcfg.remat == "block" and pcfg.logit_chunk == 1024
          and pcfg.opt_state_dtype == "float32",
          f"{LM_ARCH} bundle's training plan changed: {pcfg}")
    shape = ShapeConfig("phase_i", "train", I_SEQ, I_MB * I_ACCUM)
    tokens = I_MB * I_ACCUM * I_SEQ

    def stream():
        for item in synthetic_token_stream(cfg.vocab_size, I_SEQ,
                                           I_MB * I_ACCUM, seed=seed):
            yield {k: item[k].reshape(I_ACCUM, I_MB, I_SEQ)
                   for k in ("tokens", "labels")}

    data = PrefetchIterator(stream(), depth=2)
    batches = [data.get(timeout=WAIT_S) for _ in range(I_STEPS + 1)]

    def fresh(pc):
        gen = torch.Generator(device=device).manual_seed(seed)
        return tr.init_train_state(cfg, pc, gen, device)

    gc.collect()  # nothing of the earlier phases' models may linger
    torch.cuda.empty_cache()
    rec_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state0, rec_init_ms = synced_ms(lambda: fresh(pcfg))
    params = state0.params
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_matmul = n_params - params["embed"].numel()
    # PaLM's model flops (appendix B): 6 N a token for the weights N that
    # multiply (all but the input embedding's gather), and 12 L H hd S a
    # token for attention; remat's recomputation is not counted
    flops = tokens * (6 * n_matmul + 12 * cfg.n_layers * cfg.n_heads
                      * cfg.head_dim * I_SEQ)
    rec = {"arch": LM_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "seq": I_SEQ, "microbatch": I_MB,
           "accum": I_ACCUM, "tokens_per_step": tokens,
           "n_params": n_params, "n_params_matmul": n_matmul,
           "model_flops_per_step": flops, "init_ms": rec_init_ms,
           "bytes_before": rec_base,
           "schedule": I_SCHEDULE,
           # the reckoning the depth was cut by: bf16 params 2 B and f32
           # moments 8 B, old and new side by side in the out-of-place
           # update, f32 gradients 4 B and about as much in temporaries
           "peak_bytes_reckoned": n_params * (2 * (2 + 8) + 4 + 4)}

    # I.1: chunked against unchunked loss, on the same params and batch
    mb0 = {k: torch.from_numpy(v[0]).to(device)
           for k, v in batches[0].items()}
    with torch.no_grad():
        chunked = float(tr.lm_loss(params, cfg, pcfg, mb0)[0])
        full = float(tr.lm_loss(params, cfg, pcfg.with_(logit_chunk=0),
                                mb0)[0])
    rec.update(loss_chunked=chunked, loss_unchunked=full)
    check(np.isfinite(chunked) and abs(chunked - full) <= I_CHUNK_RTOL
          * abs(full), f"I.1 chunked loss {chunked} != unchunked {full}")

    # I.2: the attention backward at one layer's shape
    rec["attention"] = attention_grad_check(device, seed + 7)

    # I.5 (and the stream's first step): two runs of one step from one
    # state give the same bits: the params compared whole, every other
    # tensor by its digest
    step = tr.make_train_step(cfg, pcfg, shape, **I_SCHEDULE)
    s1, m1 = step(state0, batches[0])
    kept = tree_leaves(s1.params)
    digests = [bits_digest(t) for t in state_tensors(s1)[len(kept):]]
    metrics1 = {k: float(v) for k, v in m1.items()}
    del s1, m1
    state, m2 = step(state0, batches[0])
    del state0, params
    metrics2 = {k: float(v) for k, v in m2.items()}
    check(all(np.isfinite(v) for v in metrics1.values()),
          f"I.1 step metrics {metrics1}")
    check(metrics1 == metrics2, f"I.5 metrics {metrics1} != {metrics2}")
    check(all(torch.equal(a, b) for a, b in
              zip(kept, tree_leaves(state.params))),
          "I.5 two runs of one step gave other params")
    check(digests == [bits_digest(t) for t in
                      state_tensors(state)[len(kept):]],
          "I.5 two runs of one step gave other optimizer state")
    del kept
    rec["step0"] = metrics1

    # I.3: the stream
    losses, ms = [metrics1["loss"]], []
    for batch in batches[1:]:
        (state, m), t = synced_ms(lambda: step(state, batch))
        losses.append(float(m["loss"]))
        check(np.isfinite(losses[-1]) and np.isfinite(float(
            m["grad_norm"])), f"I.3 step {len(losses) - 1}: {m}")
        ms.append(t)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["profile"] = device_profile(lambda: step(state, batches[-1]),
                                    I_PROFILE_GROUPS, n_top=12)
    del state
    torch.cuda.empty_cache()
    med = statistics.median(ms)
    rec.update(losses=losses, step_ms=ms, ms_per_step=med,
               tokens_per_s=tokens / med * 1e3,
               mfu=flops / (med / 1e3) / BF16_TC_FLOPS,
               loss_fall=losses[0] - statistics.mean(losses[-5:]))
    check(rec["loss_fall"] >= I_FALL, f"I.3 loss fell {rec['loss_fall']:.4f}"
          f" (< {I_FALL}): {losses}")

    # I.4: int8 states, and gradient compression, against the f32 run
    for name, pc in (("int8_states", pcfg.with_(opt_state_dtype="int8")),
                     ("grad_compression",
                      pcfg.with_(grad_compression=True))):
        torch.cuda.reset_peak_memory_stats()
        vstep = tr.make_train_step(cfg, pc, shape, **I_SCHEDULE)
        st, vl = fresh(pc), []
        check((st.err_buf is not None) == pc.grad_compression,
              f"I.4 {name} error buffer")
        for batch in batches[:I_VARIANT_STEPS]:
            st, m = vstep(st, batch)
            vl.append(float(m["loss"]))
        del st
        torch.cuda.empty_cache()
        gap = max(abs(a - b) for a, b in zip(vl, losses))
        rec[name] = {"losses": vl, "max_gap_to_f32": gap,
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        check(gap <= I_VARIANT_GAP, f"I.4 {name}: losses {vl} against "
              f"f32 {losses[:I_VARIANT_STEPS]}")
    rec["launches"] = ops.launch_counts()
    check(set(rec["launches"].values()) == {0},
          f"a port kernel launched on the LM train path: {rec['launches']}")
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def flash_entries(gen, device, ops, ref, launches: int):
    """Phase C for the flash kernel: phase D's shape (bf16, timed, and
    timed again in float32 on the CUDA-core path) and a float32 case with
    a ragged kv length and q_offset."""
    errs, entry = {}, None
    for name, bh, sq, sk, d, dt, off in FLASH_CASES:
        q, k, v = (torch.randn((bh, s, d), generator=gen, device=device)
                   .to(dt) for s in (sq, sk, sk))
        kw = dict(causal=True, scale=d**-0.5, q_offset=off)
        got = ops._flash_cuda(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        err = float((got.float() - want.float()).abs().max())
        tol = FLASH_TOL[dt]
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"flash kernel ({name}) != plain: max abs err {err}")
        errs[name] = err
        if entry is not None:
            continue
        rows = torch.arange(sq, device=device) + off
        pairs = int((rows + 1).clamp(0, sk).sum())  # causal (row, key)
        flops = 4 * d * bh * pairs
        bnd, by = bound(4 * bh * sq * d * q.element_size(), flops,
                        BF16_TC_FLOPS)
        q4, k4, v4 = (t.view(4, bh // 4, -1, d) for t in (q, k, v))
        lib = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        entry = {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:140",
            "launches": launches, "max_abs_err": err,
            "ms": timed_ms(lambda: ops._flash_cuda(q, k, v, **kw), 20),
            "call_ms": call_ms(lambda: ops._flash_cuda(q, k, v, **kw), 20),
            "plain_ms": timed_ms(
                lambda: ref.flash_attention_ref(q, k, v, **kw), 2),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True), 10),
            "library_max_abs_err": float(
                (lib.reshape(got.shape).float() - want.float()).abs().max()),
            "shape": f"bh={bh} sq={sq} sk={sk} d={d} {dt} causal"}
        entry["rate"] = f"{flops / entry['ms'] / 1e9:.1f} TFLOP/s"
        # the float32 path (CUDA cores) at the same shape
        q, k, v = (t.float() for t in (q, k, v))
        entry["f32_ms"] = timed_ms(lambda: ops._flash_cuda(q, k, v, **kw), 3)
    entry["case_errs"] = errs
    return entry


def pm1_expand(sigs: torch.Tensor) -> torch.Tensor:
    """(n, w) int32 signatures -> (n, 32 w) int8, bit i of a word -> 1 - 2
    bit (any fixed bit order gives the same distances)."""
    shifts = torch.arange(32, device=sigs.device, dtype=torch.int32)
    bits = (sigs[:, :, None] >> shifts) & 1
    return (1 - 2 * bits).to(torch.int8).reshape(sigs.shape[0], -1)


def pm1_product_ms(qs, db, ref) -> tuple[float, bool]:
    """Phase C, informative: `torch._int_mm` of the +-1-expanded queries
    and DB (K-major), the streaming kernel's distance product alone with
    no selection. Its distances (32 w - dot) / 2 are checked against the
    plain Hamming distances on the first 4096 rows."""
    a, b = pm1_expand(qs), pm1_expand(db)
    w32 = a.shape[1]
    dot = torch._int_mm(a, b[:4096].t())
    ok = bool(torch.equal((w32 - dot) // 2,
                          ref.hamming_distance_ref(qs, db[:4096])))
    ms = timed_ms(lambda: torch._int_mm(a, b.t()), 10)
    return ms, ok


def plain_hamming(ref, qs, db, chunk=1 << 15):
    """The plain Hamming distances, a slice of rows at a time."""
    return torch.cat([ref.hamming_distance_ref(qs, db[i:i + chunk])
                      for i in range(0, db.shape[0], chunk)], dim=1)


def hamming_entry(qa, db_a, db_max, ops, ref, launches: int) -> dict:
    """Phase C for the Hamming kernel: bit-equal to the plain version at
    phase A's shape and at the largest dense catalog (`db_max`), each
    timed beside its bound (the int32 output's bytes; the +-1 product on
    the int8 tensor cores is below them) and the POPC floor of any
    CUDA-core design. Informative: `torch._int_mm` on the +-1 operands
    (the product alone; its n must be a multiple of 8)."""
    q, w = qa.shape
    shapes = {}
    for name, db in (("phase_a", db_a), ("dense_max", db_max)):
        n = db.shape[0]
        check(torch.equal(ops._hamming_cuda(qa, db),
                          plain_hamming(ref, qa, db)),
              f"hamming kernel ({name}) != plain")
        bnd, by = bound(4 * (q * w + n * w + q * n), 2 * q * n * 32 * w,
                        INT8_TC_OPS)
        reps = 200 if n < 10_000 else 20
        prod_ms, prod_ok = pm1_product_ms(qa, db[:n // 8 * 8], ref)
        check(prod_ok, f"+-1 _int_mm distances ({name}) != plain")
        shapes[name] = {
            "shape": f"q={q} n={n} words={w}",
            "ms": timed_ms(lambda: ops._hamming_cuda(qa, db), reps),
            "call_ms": call_ms(lambda: ops._hamming_cuda(qa, db), reps),
            "plain_ms": timed_ms(lambda: plain_hamming(ref, qa, db), 3),
            "bound_ms": bnd, "bound_by": by,
            "popc_floor_ms": q * n * w / POPC_PER_S * 1e3,
            "pm1_int_mm_ms": prod_ms}
    main = shapes["phase_a"]
    return {"name": "hamming_distances", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/hamming.cu",
            "replaces": "src/repro/kernels/hamming_nns.py:57",
            "launches": launches, "max_abs_err": 0.0,
            **{k: main[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                    "bound_by", "shape")},
            "library_ms": None, "extra": shapes}


def pool_stage_bytes_ops(plan, ids, valid, sides=None) -> tuple[int, int]:
    """The least a grouped pool must move and compute for these inputs:
    each distinct live row of a table (its clamped id) read once, d int8
    values and an f32 scale, however many slots name it; every id, the
    valid mask and the counted segments' hot ids read once; every output
    row and the counters written once; and (v * s) * w + acc per live slot
    and column. A segment's side table (its own, or this call's in
    `sides`) is read once, D slots of d + 4 bytes and its D ids; slots it
    serves, and slots past the table that it turns to zeros, read no row
    of the table."""
    n_bytes = (0 if valid is None else valid.numel()) + 8 * plan.counted
    n_ops = 0
    live_rows: dict = {}  # table -> (d, its live row ids)
    side_tables: dict = {}  # side table -> its bytes
    for i, (seg, x) in enumerate(zip(plan.segments, ids)):
        if valid is not None and seg.masked:
            x = torch.where(valid[:, None], x, -1)
        n, d = seg.values.shape
        side = seg.side if sides is None or sides[i] is None else sides[i]
        live = x[x >= 0]
        n_ops += 3 * live.numel() * d
        if side is not None and side.ids.numel():
            D = side.ids.numel()
            side_tables[side.ids.data_ptr()] = D * (d + 4) + 4 * D
            live = live[~torch.isin(live, side.ids) & (live < n)]
        else:
            live = live.clamp(max=n - 1)
        prev = live_rows.get(seg.values.data_ptr(), (d, live[:0]))[1]
        live_rows[seg.values.data_ptr()] = (d, torch.cat([prev, live]))
        rows = x.numel() if seg.mode == "rows" else x.shape[0]
        hot = (seg.hot_ids.numel()
               if seg.counted and seg.hot_ids is not None else 0)
        n_bytes += 4 * x.numel() + 4 * rows * d + 4 * hot
    for d, live in live_rows.values():
        n_bytes += int(torch.unique(live).numel()) * (d + 4)
    return n_bytes + sum(side_tables.values()), n_ops


def tiered_rank_stage(live_eng, cand, ops):
    """The tiered catalog's rank stage at phase A's candidates: a candidate
    segment with no base rows and a per-call overlay of one slot a
    candidate (`TieredCatalog._build_overlay`'s layout), and the genre
    bag -> (plan, sides)."""
    from repro_torch.core.nns import EMPTY_ID

    plan = live_eng.rank_plan
    seg = plan.segments[0]
    empty = seg._replace(values=seg.values[:0], scales=seg.scales[:0],
                         side=None)
    flat = cand.flatten()
    ov_ids = torch.where(flat >= 0, flat, EMPTY_ID)
    order = torch.sort(ov_ids, stable=True).indices
    safe = flat.clamp(min=0).long()[order]
    overlay = ops.SideTable(ids=ov_ids[order].contiguous(),
                            values=seg.values[safe].contiguous(),
                            scales=seg.scales[safe].contiguous())
    return ops.PoolPlan([empty, plan.segments[1]]), [overlay, None]


def pool_entry(eng, batch, cand, ops, ref, launches: int, live_eng,
               online: dict) -> dict:
    """Phase C for the grouped pool kernel, at phase A's lookup and rank
    stages (one launch each, bit-equal to the plain version with equal
    counters); the same stages of F.1's live engine, whose history and
    candidate segments resolve through its 1,024-slot delta as their side
    table (searched in shared memory), and of G.3's live engine at a
    bucket of G.3's queries and its own candidates, in both states it
    serves in: its 3,000-slot delta empty and full (searched in global
    memory, past the kernel's shared-memory limit); the tiered rank stage
    (a per-call overlay, no base rows); and the single-table public op
    (genre, history, weighted history; bit-equal). Informative:
    `F.embedding_bag` over the dequantized f32 tables, the library's
    nearest call (the port never calls it)."""
    from repro_torch.core.quantization import dequantize_rowwise

    b = eng.batch_to_device(batch)
    valid = b.get("valid")
    dev = cand.device
    B, N = cand.shape
    names = sorted(eng.cfg.user_features)
    tiered_plan, tiered_sides = tiered_rank_stage(live_eng, cand, ops)
    served = [("", eng, b, cand), ("live_", live_eng, b, cand)]
    g_batch = online["batch"]
    for prefix, e in online["engines"].items():
        served.append((prefix, e, e.batch_to_device(g_batch),
                       e.serve(g_batch).nns.indices))
    stages = {}
    for prefix, e, bb, cc in served:
        Bq, Nq = cc.shape
        stages[prefix + "lookup"] = (
            e.lookup_plan, [bb[k][:, None] for k in names] + [bb["history"]],
            lambda e=e, Bq=Bq: [torch.empty((Bq, e.lookup_plan.width),
                                            device=dev)] * (len(names) + 1),
            None, bb.get("valid"))
        stages[prefix + "rank"] = (
            e.rank_plan, [cc, bb["genre"][:, None]],
            lambda e=e, Bq=Bq, Nq=Nq: [
                torch.empty((Bq, Nq, e.rank_plan.width), device=dev),
                torch.empty((Bq, e.genre_table_q.values.shape[1]),
                            device=dev)], None, bb.get("valid"))
    stages["tiered_rank"] = (tiered_plan, [cand, b["genre"][:, None]],
                             stages["live_rank"][2], tiered_sides, valid)
    out = {}
    for name, (plan, ids, new_outs, sides, vmask) in stages.items():
        got, want = new_outs(), new_outs()
        for o in got + want:
            o.fill_(-7.0)
        c_got = plan.launch(ids, got, vmask, sides=sides)
        c_want = ref.grouped_pool_ref(plan.segments, ids, want, vmask,
                                      sides=sides)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"grouped pool ({name} stage) != plain")
        check(torch.equal(c_got, c_want),
              f"grouped pool ({name} stage) counters != plain")
        bnd, by = bound(*pool_stage_bytes_ops(plan, ids, vmask, sides))
        outs = new_outs()
        side_of = [seg.side if sides is None or sides[i] is None
                   else sides[i] for i, seg in enumerate(plan.segments)]
        out[name] = {
            "shape": ", ".join(
                f"{seg.mode} {tuple(x.shape)} of {seg.values.shape[0]}x"
                f"{seg.values.shape[1]}"
                + ("" if sd is None else
                   f" + side table of {sd.ids.shape[0]}")
                for seg, x, sd in zip(plan.segments, ids, side_of)),
            "ms": timed_ms(lambda: plan.launch(ids, outs, vmask,
                                               sides=sides), 200),
            "call_ms": call_ms(lambda: ops.grouped_pool(
                plan, ids, outs, vmask, sides=sides), 200),
            "plain_ms": timed_ms(lambda: ref.grouped_pool_ref(
                plan.segments, ids, outs, vmask, sides=sides), 20),
            "bound_ms": bnd, "bound_by": by,
            "counters": [int(c) for c in c_got]}

    # the public op: one segment a launch
    gt, it = eng.genre_table_q, eng.item_table_q
    hw = torch.rand(b["history"].shape, device=dev)
    genre_ids = b["genre"][:, None]
    for table, ids, wts in ((gt, genre_ids, None), (it, b["history"], None),
                            (it, b["history"], hw)):
        check(torch.equal(ops.embedding_pool(table.values, table.scales, ids,
                                             wts),
                          ref.embedding_pool_ref(table.values, table.scales,
                                                 ids, wts)),
              "embedding_pool op != plain")
    out["genre_op"] = {
        "shape": f"B={B} L=1 n={gt.values.shape[0]} d={gt.values.shape[1]}",
        "ms": timed_ms(lambda: ops.embedding_pool(
            gt.values, gt.scales, genre_ids), 200),
        "call_ms": call_ms(lambda: ops.embedding_pool(
            gt.values, gt.scales, genre_ids), 200)}

    # informative: F.embedding_bag over the dequantized f32 tables, -1 ids
    # sent to an appended zero row that `padding_idx` leaves out
    def f32_bag(table, ids, mode):
        w = torch.cat([dequantize_rowwise(table),
                       torch.zeros((1, table.values.shape[1]), device=dev)])
        x = torch.where(ids >= 0, ids, w.shape[0] - 1).long()
        return (lambda: F.embedding_bag(x, w, mode=mode,
                                        padding_idx=w.shape[0] - 1))

    bags = [f32_bag(eng.tables_q[k], b[k][:, None], "sum") for k in names]
    bags.append(f32_bag(it, b["history"], "mean"))
    lib = torch.cat([f() for f in bags], dim=-1)
    ours = torch.empty((B, eng.lookup_plan.width), device=dev)
    ops.grouped_pool(eng.lookup_plan, stages["lookup"][1], [ours] * len(bags),
                     valid)
    out["embedding_bag_f32"] = {
        "lookup_stage_ms": timed_ms(lambda: [f() for f in bags], 50),
        "history_ms": timed_ms(bags[-1], 200),
        "max_abs_diff_vs_kernel": float((lib - ours).abs().max())}

    main = out["lookup"]
    return {"name": "embedding_pool", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/embedding_pool.cu",
            "replaces": "src/repro/kernels/embedding_pool.py:68",
            "launches": launches, "max_abs_err": 0.0,
            **{k: main[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                    "bound_by", "shape")},
            "library_ms": None, "extra": out}


def int8_entry(operands: dict, ops, ref, launches: int):
    """Phase C for the int8 matmul: bit-equal at both shapes; timed at the
    MLP up-projection."""
    for name, args in operands.items():
        got = ops._int8_matmul_cuda(*args)
        check(torch.equal(got, ref.int8_matmul_ref(*args)),
              f"int8_matmul kernel ({name}) != plain")
    x, w, sx, sw = operands["big"]
    m, k = x.shape
    n = w.shape[1]
    bnd, by = bound(m * k + k * n + 4 * (m + n) + 4 * m * n, 2 * m * n * k,
                    INT8_TC_OPS)
    got = ops._int8_matmul_cuda(x, w, sx, sw)
    wt = w.t().contiguous()  # K-major W for the library's second layout

    def library(w_op):
        return (torch._int_mm(x, w_op).float() * sx) * sw

    lib_ms = {"n_major": timed_ms(lambda: library(w), 10),
              "k_major": timed_ms(lambda: library(wt.t()), 10)}
    ms = timed_ms(lambda: ops._int8_matmul_cuda(x, w, sx, sw), 10)
    return {
        "name": "int8_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/int8_matmul.py:76",
        "launches": launches, "max_abs_err": 0.0,
        "ms": ms, "rate": f"{2 * m * n * k / ms / 1e9:.1f} TOP/s",
        "call_ms": call_ms(lambda: ops._int8_matmul_cuda(x, w, sx, sw), 10),
        "plain_ms": timed_ms(lambda: ref.int8_matmul_ref(x, w, sx, sw), 2),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": min(lib_ms.values()), "library_layouts_ms": lib_ms,
        "library_equal": {name: bool(torch.equal(library(w_op), got))
                          for name, w_op in (("n_major", w),
                                             ("k_major", wt.t()))},
        "small_ms": timed_ms(
            lambda: ops._int8_matmul_cuda(*operands["small"]), 50),
        "shape": f"m={m} k={k} n={n}"}


def profile_run(args) -> int:
    """`--profile`: phases A and B's engines and batches (`serve_inputs`),
    built by the port under `--src`, so that two source trees, such as a
    change and its parent unpacked with `git archive`, compare in one call
    on one card. No check, no kernel table: per phase one JSON line of
    `step_times` over `PROFILE_STEPS` steps, then one of `ops.hamming_distances`
    timed at phase A's shape (its 256 query signatures x 3000 items) and at
    the largest dense catalog (the same queries x phase B's first
    `STREAM_MIN_ITEMS` - 1 item signatures). Prints the card's name and
    power limit first."""
    from repro_torch.core.lsh import lsh_signature
    from repro_torch.core.nns import STREAM_MIN_ITEMS
    from repro_torch.kernels import build, ops
    from repro_torch.serving import recsys_engine as rs_mod
    from repro_torch.utils import resolve_device

    device = resolve_device("cuda")
    print(f"card: {card_line()}", flush=True)
    build.build_all()
    _, proj, inputs = serve_inputs(args.seed, device)
    sigs = {}
    for name, inp in inputs.items():
        eng = rs_mod.RecSysEngine.build(
            inp["params"], inp["cfg"], lsh_proj=proj, hot_rows=HOT_ROWS,
            item_freqs=inp["freqs"], device=device)
        batch = inp["batches"][0]
        sigs[name] = (lsh_signature(eng.user_embedding(batch),
                                    eng.lsh_proj), eng.item_sigs)
        print(json.dumps({"src": str(args.src), "phase": name,
                          "n_items": inp["cfg"].n_items, "batch": BATCH,
                          **step_times(eng, batch, rs_mod, ops,
                                       PROFILE_STEPS)}), flush=True)
        del eng
        torch.cuda.empty_cache()
    qa, db_a = sigs["A"]
    db_max = sigs["B"][1][:STREAM_MIN_ITEMS - 1]
    print(json.dumps({"src": str(args.src), "hamming_ms": {
        f"q={qa.shape[0]} n={db.shape[0]}": timed_ms(
            lambda: ops.hamming_distances(qa, db), reps)
        for db, reps in ((db_a, 200), (db_max, 20))}}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--record", type=Path, default=None,
                    help="write the full record of the run here as JSON")
    ap.add_argument("--profile", action="store_true",
                    help="only time phases A and B's serve steps and the "
                         "Hamming op (see `profile_run`)")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="with --profile: the port's sources to import, "
                         "e.g. a parent tree unpacked with git archive")
    args = ap.parse_args(argv)
    if args.src != SRC and not args.profile:
        ap.error("--src needs --profile")
    if not torch.cuda.is_available():
        print("chip_smoke: no GPU (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if not (args.src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {args.src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    if args.profile:
        return profile_run(args)
    from repro_torch.core.lsh import lsh_signature
    from repro_torch.core.nns import (
        STREAM_MIN_ITEMS,
        _plan_streams,
        _prune_mask,
        fixed_radius_nns,
    )
    from repro_torch.kernels import build, ops, ref
    from repro_torch.serving import recsys_engine as rs_mod
    from repro_torch.utils import resolve_device

    device = resolve_device("cuda")  # also turns TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s (nvcc, {len(build.KERNELS)} "
          f"sources in parallel)", flush=True)

    gen, proj, inputs = serve_inputs(args.seed, device)
    record = {"card": card, "build_s": build_s, "seed": args.seed}

    # -- phase A: MovieLens config, dense plan -----------------------------
    cfg, params_a = inputs["A"]["cfg"], inputs["A"]["params"]
    eng_a = rs_mod.RecSysEngine.build(
        params_a, cfg, lsh_proj=proj, hot_rows=HOT_ROWS,
        item_freqs=inputs["A"]["freqs"], device=device)
    check(not _plan_streams(eng_a.item_sigs.shape[0], eng_a.scan_block),
          "phase A should take the dense plan")
    batches_a = inputs["A"]["batches"]
    a = serve_phase(eng_a, batches_a, cfg.n_items, ops)
    a["cpu_check"] = cpu_reference_check(params_a, cfg, proj, eng_a,
                                         batches_a[0], rs_mod)
    check(a["launches"]["hamming_distances"] == N_BATCHES_A,
          f"phase A launches {a['launches']}")
    check(a["launches"]["embedding_pool"] == 2 * N_BATCHES_A,
          f"phase A launches {a['launches']} (one pool launch a stage)")
    check(a["launches"]["streaming_nns"] == 0, "phase A streamed")
    a.update(step_times(eng_a, batches_a[0], rs_mod, ops, STEPS))
    print(f"phase A (dense, {cfg.n_items} items): "
          f"{a['ms_per_batch']:.3f} ms/batch of {BATCH}, "
          f"{a['queries_per_s']:.0f} q/s, launches {a['launches']}, "
          f"cache {a['cache']}, stages {a['stage_ms']}, "
          f"cpu check {a['cpu_check']}", flush=True)

    # -- phase B: 1,048,576 items, pruned streaming plan --------------------
    t0 = time.perf_counter()
    eng_b = rs_mod.RecSysEngine.build(
        inputs["B"]["params"], inputs["B"]["cfg"], lsh_proj=proj,
        hot_rows=HOT_ROWS, item_freqs=inputs["B"]["freqs"], device=device)
    torch.cuda.synchronize()
    build_b_s = time.perf_counter() - t0
    check(_plan_streams(eng_b.item_sigs.shape[0], eng_b.scan_block)
          and eng_b.block_summary is not None,
          "phase B should take the pruned streaming plan")
    batches_b = inputs["B"]["batches"]
    b = serve_phase(eng_b, batches_b, N_ITEMS_B, ops)
    b["build_s"] = build_b_s
    check(b["launches"]["streaming_nns"] == N_BATCHES_B,
          f"phase B launches {b['launches']}")
    check(b["launches"]["embedding_pool"] == 2 * N_BATCHES_B,
          f"phase B launches {b['launches']} (one pool launch a stage)")
    check(b["launches"]["hamming_distances"] == 0, "phase B went dense")
    b.update(step_times(eng_b, batches_b[0], rs_mod, ops, STEPS))
    touched = b["results"][0].nns.blocks_touched
    b["blocks_touched_mean"] = float(touched.float().mean())
    b["summary_blocks"] = eng_b.block_summary.n_blocks
    print(f"phase B (pruned streaming, {N_ITEMS_B} items): engine build "
          f"{build_b_s:.2f} s, {b['ms_per_batch']:.3f} ms/batch of {BATCH}, "
          f"{b['queries_per_s']:.0f} q/s, launches {b['launches']}, "
          f"blocks touched {b['blocks_touched_mean']:.1f} of "
          f"{b['summary_blocks']}, cache {b['cache']}, "
          f"stages {b['stage_ms']}", flush=True)

    # -- phase E: the serving front-ends over A's and B's engines ----------
    e = serving_phase(eng_a, eng_b, inputs, args.seed, ops, card)

    # -- phase F: the live catalog (A's and B's engines) and the tiered one -
    cat_f = catalog_phase(eng_a, eng_b, inputs, args.seed, ops, card)
    torch.cuda.empty_cache()

    # -- phase G: training and train-while-serve at full width -------------
    train = training_phase(proj, args.seed, device, ops, card)
    torch.cuda.empty_cache()

    # -- phase H: the multi-GPU plans at world size 1, banks on one card ----
    mesh = mesh_phase(eng_a, eng_b, inputs, a, b, args.seed, ops, card)

    # -- phase D: Qwen3-8B, full width and depth, prefill and decode --------
    lm_rec, int8_operands = lm_phase(args.seed, device, ops)
    torch.cuda.empty_cache()
    print(f"phase D ({LM_ARCH}, {lm_rec['layers']} layers, bf16, batch "
          f"{LM_BATCH}, prompt {LM_PROMPT}, int8 cache; {card}): weights "
          f"{lm_rec['weight_bytes']} B ({lm_rec['n_params']} params), "
          f"prefill blocked {lm_rec['prefill_blocked_ms']:.1f} ms, flash "
          f"{lm_rec['prefill_flash_ms']:.1f} ms (launches "
          f"{lm_rec['launches']['flash_attention']}), decode "
          f"{lm_rec['decode_ms_per_step']:.2f} ms/step, generate "
          f"{lm_rec['generate_ms']:.1f} ms for {LM_GEN} tokens x {LM_BATCH} "
          f"= {lm_rec['tokens_per_s']:.1f} tok/s, flash-vs-blocked logits "
          f"{lm_rec['prefill_logit_diff_frac']:.4f} of the spread, greedy "
          f"gap {lm_rec['prefill_gap_frac']:.4f}, decode gap max "
          f"{lm_rec['decode_gap_frac_max']:.4f}, int8 up-projection rel err "
          f"{lm_rec['int8_rel_err_vs_bf16']:.4f}, max memory allocated "
          f"{lm_rec['max_memory_allocated']} B", flush=True)

    # -- phase I: LM training, Qwen3-8B at full width, depth cut ----------
    lm_train = lm_train_phase(args.seed, device, ops)
    att = lm_train["attention"]
    print(f"phase I.1 ({LM_ARCH} at full width, {lm_train['layers']} of "
          f"{lm_rec['layers']} layers, bf16, f32 AdamW, remat block, logit "
          f"chunk 1024; {card}): {lm_train['n_params']} params, loss "
          f"chunked {lm_train['loss_chunked']:.6f} / unchunked "
          f"{lm_train['loss_unchunked']:.6f}, step 0 {lm_train['step0']}",
          flush=True)
    print(f"phase I.2 attention backward ({att['shape']}) vs autograd "
          f"through the materialized softmax: max abs err dq "
          f"{att['dq_max_abs_err']:.3g} dk {att['dk_max_abs_err']:.3g} dv "
          f"{att['dv_max_abs_err']:.3g}; fwd+bwd "
          f"{att['fwd_bwd_ms_tf32_off']:.2f} ms (TF32 off), "
          f"{att['fwd_bwd_ms_tf32_on']:.2f} ms (TF32 on), "
          f"materialized {att['materialized_fwd_bwd_ms']:.2f} ms", flush=True)
    print(f"phase I.3 ({I_STEPS} steps of {lm_train['tokens_per_step']} "
          f"tokens: microbatch {I_MB} x {I_SEQ}, accum {I_ACCUM}; {card}): "
          f"{lm_train['ms_per_step']:.1f} ms/step (median), "
          f"{lm_train['tokens_per_s']:.0f} tokens/s, mfu "
          f"{lm_train['mfu']:.4f}, loss {lm_train['losses'][0]:.4f} -> "
          f"{lm_train['losses'][-1]:.4f} (fell {lm_train['loss_fall']:.4f}),"
          f" peak memory {lm_train['peak_bytes']} B (reckoned "
          f"{lm_train['peak_bytes_reckoned']} B; {lm_train['bytes_before']} "
          f"B held by earlier phases)", flush=True)
    for name in ("int8_states", "grad_compression"):
        v = lm_train[name]
        print(f"phase I.4 {name.replace('_', ' ')}: losses "
              f"{[round(x, 4) for x in v['losses']]}, max gap to f32 "
              f"{v['max_gap_to_f32']:.4f}, peak memory {v['peak_bytes']} B",
              flush=True)
    print(f"phase I.5: two runs of one step from one state gave equal bits; "
          f"launches {lm_train['launches']}; phase I took "
          f"{lm_train['seconds']:.1f} s", flush=True)

    for name, prof in (("A", a["profile"]), ("B", b["profile"])):
        print(f"phase {name} profile, one serve step: {prof['kernels']} "
              f"kernels ({prof['launches']} of the port's), "
              f"{prof['device_ms']:.3f} ms on the card in "
              f"{prof['wall_ms']:.3f} ms (idle share {prof['idle_share']}), "
              f"top {prof['top'][:3]}", flush=True)
    for name, prof in lm_rec["profile"].items():
        print(f"phase D profile, {name}: {prof['kernels']} kernels, "
              f"{prof['device_ms']:.1f} ms on the card in {prof['wall_ms']:.1f}"
              f" ms (idle share {prof['idle_share']}), top {prof['top'][:3]}",
              flush=True)
    prof = lm_train["profile"]
    print(f"phase I profile, one train step: {prof['kernels']} kernels, "
          f"{prof['device_ms']:.1f} ms on the card in {prof['wall_ms']:.1f} "
          f"ms (idle share {prof['idle_share']}), ms by kind "
          f"{ {k: round(v, 1) for k, v in prof['groups_ms'].items()} }, top "
          f"{prof['top']}", flush=True)

    # -- phase C: each kernel against its plain version ---------------------
    kernels = []

    # Hamming at phase A's shapes (256 query signatures x 3000 items) and at
    # the largest dense catalog (STREAM_MIN_ITEMS - 1 rows)
    qa = lsh_signature(eng_a.user_embedding(batches_a[0]), eng_a.lsh_proj)
    kernels.append(hamming_entry(
        qa, eng_a.item_sigs, eng_b.item_sigs[:STREAM_MIN_ITEMS - 1], ops,
        ref, a["launches"]["hamming_distances"]
        + b["launches"]["hamming_distances"]
        + e["launches"]["hamming_distances"]
        + cat_f["launches"]["hamming_distances"]
        + train["launches"]["hamming_distances"]
        + mesh["launches"]["hamming_distances"]))

    # embedding pool: the lookup and rank stages' segment lists of phase A
    # (one grouped launch each), and the single-table public op
    kernels.append(pool_entry(
        eng_a, batches_a[0], a["results"][0].nns.indices, ops, ref,
        a["launches"]["embedding_pool"] + b["launches"]["embedding_pool"]
        + e["launches"]["embedding_pool"]
        + cat_f["launches"]["embedding_pool"]
        + train["launches"]["embedding_pool"]
        + mesh["launches"]["embedding_pool"], cat_f.pop("live_engine"),
        train["G3"].pop("pool_check")))

    # streaming NNS at phase B's shapes: 256 queries x 1,048,576 items
    qb = lsh_signature(eng_b.user_embedding(batches_b[0]), eng_b.lsh_proj)
    db_b = eng_b.item_sigs
    summary = eng_b.block_summary
    prune, touched = _prune_mask(qb, summary, eng_b.radius)
    kw = dict(radius=eng_b.radius, max_candidates=eng_b.n_candidates)
    alive = torch.rand(db_b.shape[0], generator=gen).to(device) < 0.9
    variants = {
        "pruned": dict(prune_blocks=prune,
                       prune_block_rows=summary.block_rows),
        "unpruned": {},
        "masked": dict(db_mask=alive),
        "masked_pruned": dict(db_mask=alive, prune_blocks=prune,
                              prune_block_rows=summary.block_rows),
        "superblock_16384": dict(superblock=1 << 14),
        "n_valid_1000000": dict(n_valid=1_000_000),
    }
    outs = {}
    for name, v in variants.items():
        got = ops.streaming_nns_cuda(qb, db_b, **kw, **v)
        want = ref.streaming_nns_ref(qb, db_b, kw["radius"],
                                     kw["max_candidates"], **v)
        for g, wt, f in zip(got, want, ("indices", "distances", "counts")):
            check(torch.equal(g, wt), f"streaming kernel ({name}) {f} != "
                                      f"plain")
        outs[name] = got
    for name in ("unpruned", "superblock_16384"):
        for g, wt in zip(outs[name], outs["pruned"]):
            check(torch.equal(g, wt), f"streaming {name} != pruned")
    dense = fixed_radius_nns(qb, db_b, kw["radius"], kw["max_candidates"],
                             scan_block=0)
    for g, f in zip(outs["unpruned"], ("indices", "distances", "counts")):
        check(torch.equal(g, getattr(dense, f)),
              f"streaming {f} != dense plan")
    q, w = qb.shape
    nb, br = summary.n_blocks, summary.block_rows
    n_b = db_b.shape[0]
    block_needed = (~prune).any(dim=0)
    rows_needed = int(sum(min(br, n_b - i * br) for i in
                          torch.nonzero(block_needed).flatten().tolist()))
    pair_rows = int((~prune).sum()) * br  # admitted (query, row) pairs
    k = kw["max_candidates"]
    # the distance work on either engine, the faster counting: XOR,
    # popcount and add per word on the CUDA cores, or the +-1 int8 product
    # (2 x 32 w operations per pair) on the int8 tensor cores
    nns_bytes = (4 * (q * w + rows_needed * w) + q * nb + 8 * q * k + 4 * q)
    bnd_cc, by_cc = bound(nns_bytes, 3 * pair_rows * w)
    bnd_tc, by_tc = bound(nns_bytes, 2 * pair_rows * 32 * w, INT8_TC_OPS)
    bnd, by = min((bnd_cc, by_cc), (bnd_tc, by_tc))
    prod_ms, prod_ok = pm1_product_ms(qb, db_b, ref)
    kernels.append({
        "name": "streaming_nns", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/streaming_nns.cu",
        "replaces": "src/repro/kernels/streaming_nns.py:346",
        "launches": a["launches"]["streaming_nns"]
        + b["launches"]["streaming_nns"] + e["launches"]["streaming_nns"]
        + cat_f["launches"]["streaming_nns"]
        + train["launches"]["streaming_nns"]
        + mesh["launches"]["streaming_nns"],
        "max_abs_err": 0.0,
        "ms": timed_ms(lambda: ops.streaming_nns_cuda(
            qb, db_b, **kw, **variants["pruned"]), 20),
        "call_ms": call_ms(lambda: ops.streaming_nns_cuda(
            qb, db_b, **kw, **variants["pruned"]), 20),
        "plain_ms": timed_ms(lambda: ref.streaming_nns_ref(
            qb, db_b, kw["radius"], k, **variants["pruned"]), 3),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "bound_int8_tc_ms": bnd_tc, "bound_cuda_cores_ms": bnd_cc,
        "pm1_int_mm_ms": prod_ms, "pm1_int_mm_equal": prod_ok,
        "shape": f"q={q} n={n_b} words={w} K={k} radius={kw['radius']} "
                 f"blocks_touched={int((~prune).sum())}/{q * nb}, bound "
                 f"{bnd_tc:.4f} ms on the int8 tensor cores, {bnd_cc:.4f} "
                 f"ms on the CUDA cores"})
    print(f"streaming_nns distance product alone (informative, not "
          f"library_ms): torch._int_mm on the +-1 operands ({q} x {32 * w} "
          f"x {n_b}, int32 out) {prod_ms:.4f} ms, distances equal to the "
          f"plain Hamming on a slice: {prod_ok}", flush=True)

    gen_c = torch.Generator(device=device).manual_seed(args.seed + 2)
    kernels.append(flash_entries(gen_c, device, ops, ref,
                                 lm_rec["launches"]["flash_attention"]))
    kernels.append(int8_entry(int8_operands, ops, ref,
                              lm_rec["int8_launches"]))

    for kern in kernels:
        check(kern["launches"] > 0, f"{kern['name']} never launched")
        print(f"kernel {kern['name']}: launches {kern['launches']}, "
              f"{kern['ms']:.4f} ms on the card, {kern['call_ms']:.4f} ms "
              f"per call (plain {kern['plain_ms']:.4f} ms, bound "
              f"{kern['bound_ms']:.4f} ms by {kern['bound_by']}), max abs "
              f"err {kern['max_abs_err']:.3g}, library "
              f"{kern['library_ms']} ms, {kern['shape']}"
              + "".join(f", {key} {kern[key]}" for key in
                        ("rate", "f32_ms", "library_layouts_ms")
                        if key in kern), flush=True)
        for key, val in kern.get("extra", {}).items():
            print(f"kernel {kern['name']}, {key}: {json.dumps(val)}",
                  flush=True)

    for phase in (a, b):
        phase.pop("results")
    record.update(phase_a=a, phase_b=b, phase_d=lm_rec, phase_i=lm_train,
                  phase_e=e,
                  phase_f=cat_f, phase_g=train, phase_h=mesh,
                  kernels=kernels,
                  device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    if args.record is not None:
        args.record.parent.mkdir(parents=True, exist_ok=True)
        args.record.write_text(json.dumps(record, indent=1))
    print(card_line())  # name, power limit: nvidia-smi's own csv line
    print(json.dumps({"kernels": [{k: kern[k] for k in KERNEL_KEYS}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": record["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
