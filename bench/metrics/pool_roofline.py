"""The grouped embedding-pool kernel's share of its roofline, in percent: the
least time the card could take for the traced batches' two pool launches
(the lookup stage's and the rank stage's) over the device time of
`kernels/ops.py` `grouped_pool`'s kernel (`csrc/embedding_pool.cu`).

`stage_bytes_ops` is a frozen copy of `chip_smoke.py`'s
`pool_stage_bytes_ops` (there at line 3653), taking the segments as
(table, rows, width, ids, mode, counted, hot ids) from the configuration
and the batch rather than from the program's plan. This benchmark's cells
serve frozen catalogs in full batches, so the copy leaves out the original's
valid mask and side tables. A launch's least time is the larger of its
bytes at 3.35 TB/s and its operations at 67 TFLOP/s (float32). Layer:
kernels.
"""
from __future__ import annotations

import torch

from bench import peaks

KERNELS = r"\(anonymous namespace\)::pool_kernel\b"


def stage_bytes_ops(segments) -> tuple[int, int]:
    """The least a grouped pool must move and compute for these inputs:
    each distinct live row of a table (its clamped id) read once, d int8
    values and an f32 scale, however many slots name it; every id and the
    counted segments' hot ids read once; every output row and the counters
    written once; and (v * s) * w + acc per live slot and column."""
    n_bytes = 8 if any(seg[5] for seg in segments) else 0
    n_ops = 0
    live_rows: dict = {}  # table -> (d, its live row ids)
    for table, n, d, ids, mode, counted, hot in segments:
        live = ids[ids >= 0]
        n_ops += 3 * live.numel() * d
        live = live.clamp(max=n - 1)
        prev = live_rows.get(table, (d, live[:0]))[1]
        live_rows[table] = (d, torch.cat([prev, live]))
        rows = ids.numel() if mode == "rows" else ids.shape[0]
        n_bytes += 4 * ids.numel() + 4 * rows * d + 4 * (hot if counted
                                                         else 0)
    for d, live in live_rows.values():
        n_bytes += int(torch.unique(live).numel()) * (d + 4)
    return n_bytes, n_ops


def stages(cfg: dict, batch: dict, candidates: torch.Tensor) -> list:
    """The segments of a batch's two launches: the sorted user features'
    bags and the mean history (lookup), the candidate rows and the genre
    bag (rank)."""
    d, hot = cfg["embed_dim"], cfg["hot_rows"]
    n = cfg["n_items"]
    lookup = [(("table", k), card, d, batch[k][:, None], "sum", True,
               min(hot, card))
              for k, card in sorted(cfg["user_features"].items())]
    lookup.append(("item", n, d, batch["history"], "mean", True,
                   min(hot, n)))
    rank = [("item", n, d, candidates, "rows", True, min(hot, n)),
            ("genre", cfg["n_genres"], d, batch["genre"][:, None], "sum",
             False, 0)]
    return [lookup, rank]


def read(ctx):
    t = ctx.trace.kernel_seconds(KERNELS)
    if t <= 0:
        return None
    total = 0.0
    for b in ctx.trace.batches:
        batch = ctx.inputs(b.slot)
        for segments in stages(ctx.cfg, batch, b.result["indices"]):
            n_bytes, n_ops = stage_bytes_ops(segments)
            total += max(n_bytes / peaks.HBM_BYTES_PER_S,
                         n_ops / peaks.F32_FLOPS)
    return 100.0 * total / t
