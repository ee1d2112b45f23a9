"""The dense Hamming kernel's share of its roofline, in percent: the least
time the card could take for the traced batches' dense distance products
over the device time of `kernels/ops.py` `hamming_distances`'s kernel
(`csrc/hamming.cu`).

A product's least time is the larger of its operations at 1,979 TOP/s
((query, row) pairs, 2 ops a signature bit) and its bytes at 3.35 TB/s
(query and row signatures read once, the (q, n) int32 distances written
once): bytes bound it. Layer: kernels.
"""
from __future__ import annotations

from bench import peaks

KERNELS = r"\(anonymous namespace\)::hamming_kernel\b"


def bound_s(q: int, n: int, bits: int) -> float:
    n_bytes = 4 * (bits // 32) * (q + n) + 4 * q * n
    ops = q * n * peaks.HAMMING_OPS_PER_BIT * bits
    return max(n_bytes / peaks.HBM_BYTES_PER_S, ops / peaks.INT8_OPS)


def read(ctx):
    t = ctx.trace.kernel_seconds(KERNELS)
    if t <= 0:
        return None
    cfg = ctx.cfg
    one = bound_s(ctx.traffic["batch"], cfg["n_items"], cfg["lsh_bits"])
    return 100.0 * one * len(ctx.trace.batches) / t
