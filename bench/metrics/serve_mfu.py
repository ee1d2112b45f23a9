"""The serve step's share of the card's peak, in percent: the model's
operations for the queries whose answers landed in the window, each at its
unit's published peak, over the window's seconds.

Counted a query: the filtering MLP and the LSH projection of u in float32
(67 TFLOP/s); each (query, admitted row) Hamming pair as 2 ops a signature
bit on the int8 tensor cores (1,979 TOP/s), the admitted rows being those
of the summary blocks the pruned scan admitted (`nns.blocks_touched`), or
every row where the scan is dense or unpruned; the ranking MLP for each
returned candidate only, in float32. Layer: serve step.
"""
from __future__ import annotations

from bench import peaks


def mlp_flops(dims) -> int:
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def read(ctx):
    cfg, c, q = ctx.cfg, ctx.counters, ctx.window.queries
    if not q or ctx.window.seconds <= 0:
        return None
    d, bits, n = cfg["embed_dim"], cfg["lsh_bits"], cfg["n_items"]
    filt = mlp_flops([(len(cfg["user_features"]) + 1) * d,
                      *cfg["filter_dims"]])
    rank = mlp_flops([4 * d, *cfg["rank_dims"]])
    pairs = q * n
    if "blocks" in c:
        pairs = min(pairs, c["blocks"] * ctx.system.summary_block_rows)
    at_peak = ((q * (filt + 2 * d * bits) + c["candidates"] * rank)
               / peaks.F32_FLOPS
               + pairs * peaks.HAMMING_OPS_PER_BIT * bits / peaks.INT8_OPS)
    return 100.0 * at_peak / ctx.window.seconds
