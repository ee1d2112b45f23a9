"""Public kernel ops: the CUDA kernel for a CUDA tensor, else the plain one.

Routing follows the tensors, never an error: a CPU tensor takes the plain
PyTorch version (`kernels/ref.py`); a CUDA tensor launches the kernel
(`kernels/csrc`) and any failure raises. For comparisons on the card,
``REPRO_TORCH_<OP>=torch`` (e.g. ``REPRO_TORCH_STREAMING_NNS=torch``)
sends that op's CUDA tensors to the plain version too; ``cuda`` (or unset)
is the default. Each kernel counts its launches (`launch_counts`), which
is how a run shows that the serve path went through the kernels.

Signatures mirror `repro/kernels/ops.py`.
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import check_tensor as _check
from repro_torch.kernels.build import launch_counts, reset_launches
from repro_torch.kernels.streaming_nns import streaming_nns_cuda

__all__ = ["embedding_pool", "hamming_distances", "streaming_nns",
           "launch_counts", "reset_launches", "use_kernel"]

_MODES = ("cuda", "torch")


def use_kernel(name: str, t: torch.Tensor) -> bool:
    """True when op `name` on tensor `t` launches its CUDA kernel."""
    mode = os.environ.get(f"REPRO_TORCH_{name.upper()}", "cuda")
    if mode not in _MODES:
        raise ValueError(f"REPRO_TORCH_{name.upper()}={mode!r}: "
                         f"expected one of {_MODES}")
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return mode == "cuda"


def _hamming_cuda(queries: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    dev = queries.device
    _check("hamming_distances", queries, "queries", torch.int32, dev)
    _check("hamming_distances", db, "db", torch.int32, dev)
    q, words = queries.shape
    n, words2 = db.shape
    if words != words2 or not 1 <= words <= 8:
        raise ValueError(f"hamming_distances: words {words} vs {words2}")
    if words % 4 == 0 and db.data_ptr() % 16:
        raise ValueError("hamming_distances: db must be 16-byte aligned")
    if q > 8 * 65535:
        raise ValueError(f"hamming_distances: {q} queries exceed the grid")
    out = torch.empty((q, n), dtype=torch.int32, device=dev)
    build.HAMMING.launch(queries.data_ptr(), db.data_ptr(), out.data_ptr(),
                         q, n, words,
                         torch.cuda.current_stream(dev).cuda_stream)
    return out


def _embedding_pool_cuda(table_values, table_scales, ids, weights=None):
    dev = table_values.device
    op = "embedding_pool"
    _check(op, table_values, "table_values", torch.int8, dev)
    _check(op, table_scales, "table_scales", torch.float32, dev)
    _check(op, ids, "ids", torch.int32, dev)
    n, d = table_values.shape
    B, L = ids.shape
    if table_scales.shape != (n, 1):
        raise ValueError(f"{op}: table_scales {tuple(table_scales.shape)}")
    w_ptr = None
    if weights is not None:
        _check(op, weights, "weights", torch.float32, dev)
        if weights.shape != ids.shape:
            raise ValueError(f"{op}: weights {tuple(weights.shape)}")
        w_ptr = weights.data_ptr()
    out = torch.empty((B, d), dtype=torch.float32, device=dev)
    build.EMBEDDING_POOL.launch(
        table_values.data_ptr(), table_scales.data_ptr(), ids.data_ptr(),
        w_ptr, out.data_ptr(), n, d, B, L,
        torch.cuda.current_stream(dev).cuda_stream)
    return out


def embedding_pool(table_values, table_scales, ids, weights=None):
    """Fused int8 dequant-gather-pool: (n,d) int8 table, (B,L) ids -> (B,d)."""
    if use_kernel("embedding_pool", ids):
        return _embedding_pool_cuda(table_values, table_scales, ids, weights)
    return ref.embedding_pool_ref(table_values, table_scales, ids, weights)


def hamming_distances(queries, db):
    """(q,w) x (n,w) packed int32 signatures -> (q,n) int32 distances."""
    if use_kernel("hamming_distances", queries):
        return _hamming_cuda(queries, db)
    return ref.hamming_distance_ref(queries, db)


def streaming_nns(queries, db, *, radius, max_candidates,
                  scan_block=4096, n_valid=None, superblock=None,
                  db_mask=None, prune_blocks=None, prune_block_rows=None):
    """Streaming fixed-radius NNS over the whole DB -> (indices, distances,
    counts), equal bit for bit to the dense threshold + stable top-K.

    `scan_block` sizes the plain version's chunks; `superblock` shrinks the
    plain version's superblocks and caps the kernel's first-pass splits
    (results are invariant to both). `db_mask` (n,) bool marks rows that
    may match; `prune_blocks` (q, nb) bool with `prune_block_rows` rows per
    summary block skips blocks the caller proved empty of matches.
    """
    if use_kernel("streaming_nns", queries):
        return streaming_nns_cuda(
            queries, db, radius=radius, max_candidates=max_candidates,
            n_valid=n_valid, superblock=superblock, db_mask=db_mask,
            prune_blocks=prune_blocks, prune_block_rows=prune_block_rows)
    return ref.streaming_nns_ref(
        queries, db, radius, max_candidates, scan_block=scan_block,
        n_valid=n_valid, superblock=superblock, db_mask=db_mask,
        prune_blocks=prune_blocks, prune_block_rows=prune_block_rows)
