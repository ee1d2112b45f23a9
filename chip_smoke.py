#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`), one GPU.

    python3 chip_smoke.py [--seed 0] [--record PATH]

1. Builds the three CUDA kernels from `src/repro_torch/kernels/csrc`.
2. Phase A: the paper's YoutubeDNN/MovieLens engine (3000 items, seeded
   random weights, 128 hot rows per table) serves 256-query batches through
   `RecSysEngine.serve` on the dense plan (Hamming kernel + stable top-K).
3. Phase B: the same model with a 1,048,576-item catalog (32 MB int8 table
   and 32 MB of signatures on the card) serves on the auto-routed, pruned
   streaming plan.
   Each phase zeroes the kernels' launch counters just before its serve
   loop and reads them just after. Its outputs are checked: shapes, ranges,
   finite scores, equality with the plain PyTorch versions on the card
   (`REPRO_TORCH_<OP>=torch`), and the NNS candidates of a CPU engine
   built from the same weights, given the card's query signatures.
4. Phase C: each kernel against its plain version on the card at the
   phases' shapes (the streaming kernel also masked, unpruned, with a
   `superblock` override and against the dense plan); integer outputs must
   be equal, float outputs within 1e-5 relative. Kernel times are
   CUDA-event means over back-to-back launches queued behind a spin (warm
   L2, as in the serve loop); the wall time per call, host included, goes
   to the record as `call_ms`.

Prints one line per kernel, the card's name and power limit, a `kernels`
JSON line, and last `{"ok": true, "device": {...}}`; `--record PATH`
also writes the full record as JSON. Any failure exits nonzero. Without a
GPU, or without the repository beside it, it exits 1 and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# peak of plain (non-tensor-core) arithmetic: the float32 rate, used as an
# upper bound on the rate of integer XOR / popcount / add (Hopper executes
# popcount at a lower rate, so the true bound is higher than this one)
CUDA_CORE_OPS_PER_S = 67e12
BATCH = 256
N_BATCHES_A = 4
N_BATCHES_B = 3
N_ITEMS_B = 1 << 20
HOT_ROWS = 128
POOL_RTOL = 1e-5
# ~50 ms of GPU clock: longer than the host takes to queue a timing loop
SPIN_CYCLES = 100_000_000


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
             ("HAMMING_DISTANCES", "EMBEDDING_POOL", "STREAMING_NNS")]
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


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--record", type=Path, default=None,
                    help="write the full record of the run here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no GPU (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.core.lsh import lsh_signature, make_lsh_projections
    from repro_torch.core.nns import (
        _plan_streams,
        _prune_mask,
        fixed_radius_nns,
    )
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models.recsys import default_youtubednn_config
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

    rng = np.random.default_rng(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    cfg = default_youtubednn_config()
    proj = make_lsh_projections(cfg.embed_dim, 256, generator=gen,
                                device=device)
    record = {"card": card, "build_s": build_s, "seed": args.seed}

    # -- phase A: MovieLens config, dense plan -----------------------------
    params_a = numpy_params(cfg, args.seed)
    freqs_a = np.bincount(popular_items(rng, cfg.n_items, 1 << 16),
                          minlength=cfg.n_items)
    eng_a = rs_mod.RecSysEngine.build(
        params_a, cfg, lsh_proj=proj, hot_rows=HOT_ROWS, item_freqs=freqs_a,
        device=device)
    check(not _plan_streams(eng_a.item_sigs.shape[0], eng_a.scan_block),
          "phase A should take the dense plan")
    batches_a = [make_batch(rng, cfg, BATCH) for _ in range(N_BATCHES_A)]
    a = serve_phase(eng_a, batches_a, cfg.n_items, ops)
    a["cpu_check"] = cpu_reference_check(params_a, cfg, proj, eng_a,
                                         batches_a[0], rs_mod)
    a["stage_ms"] = stage_ms(eng_a, batches_a[0], rs_mod)
    check(a["launches"]["hamming_distances"] == N_BATCHES_A,
          f"phase A launches {a['launches']}")
    check(a["launches"]["embedding_pool"] == N_BATCHES_A,
          f"phase A launches {a['launches']}")
    check(a["launches"]["streaming_nns"] == 0, "phase A streamed")
    print(f"phase A (dense, {cfg.n_items} items): "
          f"{a['ms_per_batch']:.3f} ms/batch of {BATCH}, "
          f"{a['queries_per_s']:.0f} q/s, launches {a['launches']}, "
          f"cache {a['cache']}, stages {a['stage_ms']}, "
          f"cpu check {a['cpu_check']}", flush=True)

    # -- phase B: 1,048,576 items, pruned streaming plan --------------------
    cfg_b = cfg._replace(n_items=N_ITEMS_B)
    params_b = numpy_params(cfg_b, args.seed + 1)
    freqs_b = np.bincount(popular_items(rng, N_ITEMS_B, 1 << 18),
                          minlength=N_ITEMS_B)
    t0 = time.perf_counter()
    eng_b = rs_mod.RecSysEngine.build(
        params_b, cfg_b, lsh_proj=proj, hot_rows=HOT_ROWS,
        item_freqs=freqs_b, device=device)
    torch.cuda.synchronize()
    build_b_s = time.perf_counter() - t0
    check(_plan_streams(eng_b.item_sigs.shape[0], eng_b.scan_block)
          and eng_b.block_summary is not None,
          "phase B should take the pruned streaming plan")
    batches_b = [make_batch(rng, cfg_b, BATCH) for _ in range(N_BATCHES_B)]
    b = serve_phase(eng_b, batches_b, N_ITEMS_B, ops)
    b["build_s"] = build_b_s
    b["stage_ms"] = stage_ms(eng_b, batches_b[0], rs_mod)
    check(b["launches"]["streaming_nns"] == N_BATCHES_B,
          f"phase B launches {b['launches']}")
    check(b["launches"]["embedding_pool"] == N_BATCHES_B,
          f"phase B launches {b['launches']}")
    check(b["launches"]["hamming_distances"] == 0, "phase B went dense")
    touched = b["results"][0].nns.blocks_touched
    b["blocks_touched_mean"] = float(touched.float().mean())
    b["summary_blocks"] = eng_b.block_summary.n_blocks
    print(f"phase B (pruned streaming, {N_ITEMS_B} items): engine build "
          f"{build_b_s:.2f} s, {b['ms_per_batch']:.3f} ms/batch of {BATCH}, "
          f"{b['queries_per_s']:.0f} q/s, launches {b['launches']}, "
          f"blocks touched {b['blocks_touched_mean']:.1f} of "
          f"{b['summary_blocks']}, cache {b['cache']}, "
          f"stages {b['stage_ms']}", flush=True)

    # -- phase C: each kernel against its plain version ---------------------
    kernels = []

    # Hamming at phase A's shapes: 256 query signatures x 3000 items
    qa = lsh_signature(eng_a.user_embedding(batches_a[0]), eng_a.lsh_proj)
    db_a = eng_a.item_sigs
    got = ops._hamming_cuda(qa, db_a)
    want = ref.hamming_distance_ref(qa, db_a)
    check(torch.equal(got, want), "hamming kernel != plain")
    q, w = qa.shape
    n = db_a.shape[0]
    bnd, by = bound(4 * (q * w + n * w + q * n), 3 * q * n * w)
    kernels.append({
        "name": "hamming_distances", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hamming.cu",
        "replaces": "src/repro/kernels/hamming_nns.py:57",
        "launches": a["launches"]["hamming_distances"]
        + b["launches"]["hamming_distances"],
        "max_abs_err": 0.0,
        "ms": timed_ms(lambda: ops._hamming_cuda(qa, db_a), 200),
        "call_ms": call_ms(lambda: ops._hamming_cuda(qa, db_a), 200),
        "plain_ms": timed_ms(lambda: ref.hamming_distance_ref(qa, db_a), 20),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "shape": f"q={q} n={n} words={w}"})

    # embedding pool: the rank stage's genre bag (18 x 32 table, L = 1),
    # and a weighted, -1 padded history-shaped bag (3000 x 32, L = 20)
    genre_ids = eng_a.batch_to_device(batches_a[0])["genre"][:, None]
    gt = eng_a.genre_table_q
    hist = eng_a.batch_to_device(batches_a[0])["history"]
    hw = torch.rand(hist.shape, generator=gen).to(device)
    it = eng_a.item_table_q
    pool_err = 0.0
    for table, ids, wts in ((gt, genre_ids, None), (it, hist, None),
                            (it, hist, hw)):
        got = ops._embedding_pool_cuda(table.values, table.scales, ids, wts)
        want = ref.embedding_pool_ref(table.values, table.scales, ids, wts)
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=POOL_RTOL, atol=1e-7),
              f"embedding_pool kernel != plain (max abs err {err})")
        pool_err = max(pool_err, err)
    B, L = genre_ids.shape
    d = gt.values.shape[1]
    slots = int((genre_ids >= 0).sum())
    bnd, by = bound(slots * (d + 4) + 4 * B * L + 4 * B * d, 3 * slots * d)
    kernels.append({
        "name": "embedding_pool", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_pool.cu",
        "replaces": "src/repro/kernels/embedding_pool.py:68",
        "launches": a["launches"]["embedding_pool"]
        + b["launches"]["embedding_pool"],
        "max_abs_err": pool_err,
        "ms": timed_ms(lambda: ops._embedding_pool_cuda(
            gt.values, gt.scales, genre_ids), 200),
        "call_ms": call_ms(lambda: ops._embedding_pool_cuda(
            gt.values, gt.scales, genre_ids), 200),
        "plain_ms": timed_ms(lambda: ref.embedding_pool_ref(
            gt.values, gt.scales, genre_ids), 50),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "shape": f"B={B} L={L} n={gt.values.shape[0]} d={d}"})

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
    bnd, by = bound(4 * (q * w + rows_needed * w) + q * nb
                    + 8 * q * k + 4 * q, 3 * pair_rows * w)
    kernels.append({
        "name": "streaming_nns", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/streaming_nns.cu",
        "replaces": "src/repro/kernels/streaming_nns.py:346",
        "launches": a["launches"]["streaming_nns"]
        + b["launches"]["streaming_nns"],
        "max_abs_err": 0.0,
        "ms": timed_ms(lambda: ops.streaming_nns_cuda(
            qb, db_b, **kw, **variants["pruned"]), 20),
        "call_ms": call_ms(lambda: ops.streaming_nns_cuda(
            qb, db_b, **kw, **variants["pruned"]), 20),
        "plain_ms": timed_ms(lambda: ref.streaming_nns_ref(
            qb, db_b, kw["radius"], k, **variants["pruned"]), 3),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "shape": f"q={q} n={n_b} words={w} K={k} radius={kw['radius']} "
                 f"blocks_touched={int((~prune).sum())}/{q * nb}"})

    for kern in kernels:
        check(kern["launches"] > 0, f"{kern['name']} never launched")
        print(f"kernel {kern['name']}: launches {kern['launches']}, "
              f"{kern['ms']:.4f} ms on the card, {kern['call_ms']:.4f} ms "
              f"per call (plain {kern['plain_ms']:.4f} ms, bound "
              f"{kern['bound_ms']:.4f} ms by {kern['bound_by']}), max abs "
              f"err {kern['max_abs_err']:.3g}, {kern['shape']}", flush=True)

    for phase in (a, b):
        phase.pop("results")
    record.update(phase_a=a, phase_b=b, kernels=kernels,
                  device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    if args.record is not None:
        args.record.parent.mkdir(parents=True, exist_ok=True)
        args.record.write_text(json.dumps(record, indent=1))
    print(card_line())  # name, power limit: nvidia-smi's own csv line
    print(json.dumps({"kernels": [
        {k: v for k, v in kern.items() if k not in ("shape", "call_ms")}
        for kern in kernels]}))
    print(json.dumps({"ok": True, "device": record["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
