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

__all__ = ["embedding_pool", "flash_attention", "flash_attention_bhsd",
           "hamming_distances", "int8_matmul", "streaming_nns",
           "launch_counts", "reset_launches", "use_kernel"]

_MODES = ("cuda", "torch")
_FLASH_HEAD_DIMS = (16, 32, 64, 128)  # instantiated in flash_attention.cu
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# int8_matmul.cu sums in int32: |x w| <= 128 * 128 a term, so k * 2**14
# stays below 2**31 for k up to this
_INT8_MAX_K = 2**31 // 2**14 - 1


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


def _flash_cuda(q, k, v, *, causal, scale, q_offset):
    dev = q.device
    op = "flash_attention"
    if q.dtype not in _FLASH_DTYPES:
        raise ValueError(f"{op}: dtype {q.dtype} (float32 or bfloat16)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(op, t, name, q.dtype, dev)
    bh, sq, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d or v.shape != k.shape:
        raise ValueError(f"{op}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d not in _FLASH_HEAD_DIMS:
        raise ValueError(f"{op}: head dim {d} not in {_FLASH_HEAD_DIMS}")
    if -(-sq // 64) > 65535:
        raise ValueError(f"{op}: {sq} query rows exceed the grid")
    out = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError(f"{op}: q, k, v and out must be 16-byte aligned "
                         f"(cp.async copies 16 bytes)")
    build.FLASH_ATTENTION.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
        k.shape[1], d, _FLASH_DTYPES[q.dtype], scale, int(causal),
        q_offset, torch.cuda.current_stream(dev).cuda_stream)
    return out


def flash_attention_bhsd(q, k, v, *, causal=True, scale=None, q_offset=0):
    """(bh, sq, d) x (bh, sk, d) attention -> (bh, sq, d) in q's dtype, as
    `repro`'s `flash_attention_pallas`; `q_offset` places q[0] in the kv
    sequence for the causal mask."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if use_kernel("flash_attention", q):
        return _flash_cuda(q, k, v, causal=causal, scale=scale,
                           q_offset=int(q_offset))
    return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   q_offset=q_offset)


def flash_attention(q, k, v, *, causal=True, scale=None):
    """(b, h, s, d) attention -> (b, h, sq, d); the flash kernel on the
    card, its plain version on the CPU."""
    b, h, sq, d = q.shape
    out = flash_attention_bhsd(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * h, k.shape[2], d).contiguous(),
        v.reshape(b * h, v.shape[2], d).contiguous(),
        causal=causal, scale=scale)
    return out.reshape(b, h, sq, d)


def _int8_matmul_cuda(x, w, x_scale, w_scale):
    dev = x.device
    op = "int8_matmul"
    _check(op, x, "x", torch.int8, dev)
    _check(op, w, "w", torch.int8, dev)
    _check(op, x_scale, "x_scale", torch.float32, dev)
    _check(op, w_scale, "w_scale", torch.float32, dev)
    m, k = x.shape
    k2, n = w.shape
    if k != k2 or x_scale.shape != (m, 1) or w_scale.shape != (1, n):
        raise ValueError(f"{op}: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"x_scale {tuple(x_scale.shape)}, "
                         f"w_scale {tuple(w_scale.shape)}")
    if -(-m // 128) > 65535:
        raise ValueError(f"{op}: {m} rows exceed the grid")
    if k > _INT8_MAX_K:
        raise ValueError(f"{op}: k = {k} > {_INT8_MAX_K}: the int32 sum "
                         f"could overflow")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    build.INT8_MATMUL.launch(
        x.data_ptr(), w.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), m, n, k, torch.cuda.current_stream(dev).cuda_stream)
    return out


def int8_matmul(x, w, x_scale, w_scale):
    """int8 (m,k) @ int8 (k,n) with per-row (m,1) / per-column (1,n) f32
    scales -> f32 (m,n), equal bit for bit to the plain version."""
    if use_kernel("int8_matmul", x):
        return _int8_matmul_cuda(x, w, x_scale, w_scale)
    return ref.int8_matmul_ref(x, w, x_scale, w_scale)
