"""The streaming NNS kernels' share of their roofline, in percent: the least
time the card could take for the traced batches' scans over the device time
of the kernels that `kernels/ops.py` `streaming_nns` launches
(`csrc/streaming_nns.cu`: the scan, the distance bound and the merge).

A scan's least time is the larger of its operations at 1,979 TOP/s (each
(query, admitted row) pair 2 ops a signature bit, as the int8 tensor
cores compute a +-1 dot product; the admitted rows those of the summary
blocks the program admitted, `nns.blocks_touched`, or all rows unpruned)
and its bytes at 3.35 TB/s (the query and row signatures, the prune mask
and the (id, distance) buffers and counts written, each once). Layer:
kernels.
"""
from __future__ import annotations

from bench import peaks

KERNELS = r"\(anonymous namespace\)::(scan|bound|merge)_kernel\b"


def bound_s(q: int, n: int, bits: int, k: int, admitted_rows: int,
            n_blocks: int) -> float:
    words = bits // 32
    n_bytes = 4 * words * (q + n) + q * n_blocks + 4 * q * (2 * k + 1)
    ops = admitted_rows * peaks.HAMMING_OPS_PER_BIT * bits
    return max(n_bytes / peaks.HBM_BYTES_PER_S, ops / peaks.INT8_OPS)


def read(ctx):
    t = ctx.trace.kernel_seconds(KERNELS)
    if t <= 0:
        return None
    cfg = ctx.cfg
    n, q = cfg["n_items"], ctx.traffic["batch"]
    total = 0.0
    for b in ctx.trace.batches:
        touched = b.result["blocks_touched"]
        if touched is None:
            rows, nb = q * n, 0
        else:
            rows = int((touched.long() * ctx.system.summary_block_rows)
                       .clamp(max=n).sum())
            nb = ctx.system.summary_blocks
        total += bound_s(q, n, cfg["lsh_bits"], cfg["n_candidates"], rows,
                         nb)
    return 100.0 * total / t
