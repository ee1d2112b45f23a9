"""The frozen iMARS serving pipeline (`repro/serving/recsys_engine.py`).

Per batch, three stages (`serve_step`):

  1. `_lookup_stage`: the five user-feature bags and the mean-pooled
     history bag through the hot caches, in one launch of the grouped
     embedding-pool kernel that writes them straight into the filtering
     MLP's input, then the MLP -> u;
  2. `_scan_stage`: the LSH signature of u and the fixed-radius Hamming
     NNS over the item signatures (dense plan below `STREAM_MIN_ITEMS`
     rows, else the pruned streaming plan) -> candidates;
  3. `_rank_stage`: the candidate rows through the hot cache and the genre
     bag, in one launch of the grouped pool kernel (the rows straight into
     the ranking MLP's input), the ranking MLP, sigmoid and the threshold
     top-k -> final item ids.

The engine is a plain dataclass of tensors on one device. PyTorch runs
eagerly, so the stage functions are called directly (the reference jits
them). The two stages' pool plans (`kernels/ops.py:PoolPlan`: tables, hot
sets, modes and output columns) do not depend on the batch and are built
with the engine. The frozen engine serves `delta=None` only; the
live-catalog paths of `serving/catalog.py` stay for its port.
`ServeResult.cost` is None: the paper's cost model is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.lsh import lsh_signature
from repro_torch.core.nns import (
    NNSResult,
    build_block_summary,
    fixed_radius_nns,
)
from repro_torch.core.quantization import (
    QuantizedTensor,
    dequantize_rowwise,
    quantize_rowwise,
)
from repro_torch.core.topk import TopKResult, threshold_topk
from repro_torch.kernels import ops
from repro_torch.models import recsys as rs
from repro_torch.serving.hot_cache import (
    CacheStats,
    HotRowCache,
    build_hot_cache,
)
from repro_torch.utils import resolve_device, to_device


class ServeResult(NamedTuple):
    items: torch.Tensor  # (B, top_k) final item ids, -1 padded
    topk: TopKResult  # per-candidate CTR top-k
    nns: NNSResult  # filtering-stage candidates
    cost: None  # the paper's cost model is not ported yet
    stats: CacheStats  # hot-cache hits/lookups for this batch


@dataclasses.dataclass(frozen=True)
class RecSysEngine:
    """The deployed iMARS pipeline: int8 tables, item signatures, MLP
    weights and hot-row caches on one device, plus the serving knobs.

    ``scan_block``: None routes dense vs streaming by catalog size, 0
    forces dense, > 0 forces streaming. ``prune``: None prunes the
    streaming scan with ``block_summary``, False scans unpruned. Both are
    execution knobs only: every plan serves the same bits.
    """

    tables_q: dict  # name -> QuantizedTensor (int8 UIETs)
    item_table_q: QuantizedTensor  # int8 ItET
    genre_table_q: QuantizedTensor
    item_sigs: torch.Tensor  # (n_items, words) int32 packed signatures
    params: dict  # MLP weights (and the float tables they came from)
    lsh_proj: torch.Tensor  # (embed_dim, n_bits) f32
    item_hot: HotRowCache
    uiet_hot: dict  # name -> HotRowCache
    delta: object = None  # live-catalog overlay; None when frozen
    block_summary: object = None  # core.nns.BlockSummary | None
    cfg: rs.YoutubeDNNConfig = None
    radius: int = 96
    n_candidates: int = 50
    top_k: int = 10
    scan_block: int | None = None
    prune: bool | None = None
    # the two stages' grouped-pool plans, made from the fields above
    lookup_plan: ops.PoolPlan = dataclasses.field(init=False, repr=False,
                                                  compare=False)
    rank_plan: ops.PoolPlan = dataclasses.field(init=False, repr=False,
                                                compare=False)

    def __post_init__(self):
        object.__setattr__(self, "lookup_plan", _lookup_plan(self))
        object.__setattr__(self, "rank_plan", _rank_plan(self))

    @property
    def device(self) -> torch.device:
        return self.item_sigs.device

    @staticmethod
    def build(params: dict, cfg: rs.YoutubeDNNConfig, *,
              lsh_proj: torch.Tensor, radius: int = 96,
              n_candidates: int = 50, top_k: int = 10, hot_rows: int = 0,
              item_freqs=None, uiet_freqs: dict | None = None,
              scan_block: int | None = None, prune: bool | None = None,
              device=None) -> "RecSysEngine":
        """Quantize a trained YoutubeDNN into a serving engine on `device`
        (default `cuda`).

        params: the reference's parameter layout as tensors or numpy
        arrays (`models/recsys.py`). lsh_proj: (embed_dim, n_bits)
        projection (`core.lsh.make_lsh_projections`). hot_rows: capacity
        of each hot-row cache (0 disables); item_freqs / uiet_freqs pick
        the pinned rows. The item signatures are those of the dequantized
        int8 rows, and the block summary is built over them.
        """
        device = resolve_device(device)
        params = to_device(params, device)
        tables_q = {k: quantize_rowwise(v) for k, v in
                    params["tables"].items()}
        item_q = quantize_rowwise(params["item_table"])
        genre_q = quantize_rowwise(params["genre_table"])
        proj = to_device(lsh_proj, device)
        sigs = lsh_signature(dequantize_rowwise(item_q), proj)
        uiet_freqs = uiet_freqs or {}
        return RecSysEngine(
            cfg=cfg, tables_q=tables_q, item_table_q=item_q,
            genre_table_q=genre_q, item_sigs=sigs, params=params,
            lsh_proj=proj, item_hot=build_hot_cache(item_q, item_freqs,
                                                    hot_rows),
            uiet_hot={name: build_hot_cache(tables_q[name],
                                            uiet_freqs.get(name), hot_rows)
                      for name in tables_q},
            block_summary=build_block_summary(sigs),
            radius=radius, n_candidates=n_candidates, top_k=top_k,
            scan_block=scan_block, prune=prune)

    def batch_to_device(self, batch: dict) -> dict:
        """A request batch (numpy or tensors) as int32/bool tensors here."""
        return {k: to_device(v, self.device).to(
            torch.bool if k == "valid" else torch.int32)
            for k, v in batch.items()}

    def user_embedding(self, batch: dict) -> torch.Tensor:
        """(1a)-(1c): quantized lookups/pooling + filtering DNN."""
        u, _, _ = _features(self, self.batch_to_device(batch))
        return u

    def filter_stage(self, batch: dict) -> NNSResult:
        """(1d): fixed-radius Hamming NNS -> candidate item ids."""
        nns, _ = filter_step(self, self.batch_to_device(batch))
        return nns

    def rank_stage(self, batch: dict, cand: torch.Tensor) -> TopKResult:
        """(2a)-(2e): CTR per candidate + threshold top-k."""
        cand = to_device(cand, self.device).to(torch.int32)
        top, _ = rank_step(self, self.batch_to_device(batch), cand)
        return top

    def serve(self, batch: dict) -> ServeResult:
        """Serve one padded batch through the full query pipeline.

        batch: one (B,) int array per user feature of ``cfg``, a (B, L)
        ``history`` (-1 padded), a (B,) ``genre`` and optionally a (B,)
        bool ``valid`` mask (padding rows read zero rows and count no
        cache lookups). Returns the (B, top_k) final ids, the CTR top-k,
        the NNS candidates and this batch's CacheStats.
        """
        items, top, nns, stats = serve_step(
            self, self.batch_to_device(batch), CacheStats.zero(self.device))
        return ServeResult(items=items, topk=top, nns=nns, cost=None,
                           stats=stats)


# ---------------------------------------------------------------------------
# the grouped-pool plans of the two stages
# ---------------------------------------------------------------------------
def _segment(table: QuantizedTensor, cache: HotRowCache | None, **kw):
    hot = cache is not None and cache.capacity > 0
    return ops.PoolSegment(
        values=table.values, scales=table.scales,
        hot_ids=cache.hot_ids if hot else None,
        hot_rows=cache.hot_rows if hot else None, **kw)


def _lookup_plan(engine: RecSysEngine) -> ops.PoolPlan:
    """The sorted user features' bags, then the mean-pooled history, side
    by side in the filtering MLP's input (`_features`' concatenation)."""
    segs, col = [], 0
    for name in sorted(engine.cfg.user_features):
        table = engine.tables_q[name]
        segs.append(_segment(table, engine.uiet_hot.get(name), mode="sum",
                             column=col, counted=True))
        col += table.values.shape[1]
    segs.append(_segment(engine.item_table_q, engine.item_hot, mode="mean",
                         column=col, counted=True))
    return ops.PoolPlan(segs)


def _rank_plan(engine: RecSysEngine) -> ops.PoolPlan:
    """The candidate rows after the context [u, genre, pooled] in the
    ranking MLP's input, and the genre bag (no cache, no counters, and,
    as in the reference, read for padding rows too)."""
    ctx = (engine.params["filter_mlp"][-1]["b"].shape[0]
           + engine.genre_table_q.values.shape[1]
           + engine.item_table_q.values.shape[1])
    return ops.PoolPlan([
        _segment(engine.item_table_q, engine.item_hot, mode="rows",
                 column=ctx, counted=True),
        _segment(engine.genre_table_q, None, mode="sum", masked=False)])


def _frozen_only(engine: RecSysEngine) -> None:
    if engine.delta is not None:
        raise NotImplementedError("live-catalog serving is not ported yet")


# ---------------------------------------------------------------------------
# the pipeline stages (batch tensors already on the engine's device)
# ---------------------------------------------------------------------------
def _features(engine: RecSysEngine, batch: dict):
    """Cached lookups + filtering DNN -> (u, pooled_history, CacheStats).

    One grouped-pool launch writes every bag into its columns of the MLP's
    input; padding rows (`valid` False) count no lookups and read zeros.
    """
    _frozen_only(engine)
    plan = engine.lookup_plan
    hist = batch["history"]
    names = sorted(engine.cfg.user_features)
    x = torch.empty((hist.shape[0], plan.width), dtype=torch.float32,
                    device=hist.device)
    counts = ops.grouped_pool(plan, [batch[n][:, None] for n in names]
                              + [hist], [x] * (len(names) + 1),
                              valid=batch.get("valid"))
    u = rs._mlp_apply(engine.params["filter_mlp"], x)
    col = plan.segments[-1].column
    pooled = x[:, col:col + engine.item_table_q.values.shape[1]]
    return u, pooled, CacheStats(hits=counts[0], lookups=counts[1])


def _nns(engine: RecSysEngine, q_sigs: torch.Tensor) -> NNSResult:
    """Filtering scan over the item signatures (local plan)."""
    _frozen_only(engine)
    return fixed_radius_nns(q_sigs, engine.item_sigs, engine.radius,
                            engine.n_candidates,
                            scan_block=engine.scan_block,
                            summary=engine.block_summary, prune=engine.prune)


def filter_step(engine: RecSysEngine, batch: dict):
    """Features + filtering NNS -> (NNSResult, stats)."""
    u, _, stats = _features(engine, batch)
    return _nns(engine, lsh_signature(u, engine.lsh_proj)), stats


def _rank(engine: RecSysEngine, batch: dict, cand: torch.Tensor,
          u: torch.Tensor, pooled: torch.Tensor):
    """CTR + threshold top-k given precomputed user features.

    One grouped-pool launch writes the candidate rows into the ranking
    MLP's input (padding rows and -1 candidates read zeros and count no
    lookups) and pools the genre bag; the context fills the rest.
    """
    _frozen_only(engine)
    plan = engine.rank_plan
    valid = batch.get("valid")
    cand = cand.contiguous()
    B, N = cand.shape
    x = torch.empty((B, N, plan.width), dtype=torch.float32,
                    device=cand.device)
    genre = torch.empty((B, engine.genre_table_q.values.shape[1]),
                        dtype=torch.float32, device=cand.device)
    counts = ops.grouped_pool(plan, [cand, batch["genre"][:, None]],
                              [x, genre], valid=valid)
    ctx = torch.cat([u, genre, pooled], dim=-1)
    x[..., :ctx.shape[-1]] = ctx[:, None]
    logits = rs._mlp_apply(engine.params["rank_mlp"], x)[..., 0]
    ctr = torch.sigmoid(logits)
    keep = cand >= 0
    if valid is not None:  # padding rows: no candidates
        keep &= valid[:, None]
    ctr = torch.where(keep, ctr, float("-inf"))
    return (threshold_topk(ctr, threshold=0.0, k=engine.top_k),
            CacheStats(hits=counts[0], lookups=counts[1]))


def rank_step(engine: RecSysEngine, batch: dict, cand: torch.Tensor):
    """Rank given candidates -> (TopKResult, stats); recomputes features."""
    u, pooled, stats = _features(engine, batch)
    top, st = _rank(engine, batch, cand, u, pooled)
    return top, stats + st


def serve_step(engine: RecSysEngine, batch: dict, stats: CacheStats):
    """One serving step: features -> NNS -> rank -> final ids.

    `stats` is a running hot-cache accumulator; returns (final_items,
    topk, nns, stats').
    """
    u, pooled, stats = _lookup_stage(engine, batch, stats)
    nns = _scan_stage(engine, u)
    final, top, stats = _rank_stage(engine, batch, nns.indices, u, pooled,
                                    stats)
    return final, top, nns, stats


def _lookup_stage(engine: RecSysEngine, batch: dict, stats: CacheStats):
    """Stage 1 — ET lookups + pooling + filtering DNN -> (u, pooled,
    stats')."""
    u, pooled, st = _features(engine, batch)
    return u, pooled, stats + st


def _scan_stage(engine: RecSysEngine, u: torch.Tensor) -> NNSResult:
    """Stage 2 — LSH-sign u and run the filtering NNS."""
    return _nns(engine, lsh_signature(u, engine.lsh_proj))


def _rank_stage(engine: RecSysEngine, batch: dict, cand: torch.Tensor,
                u: torch.Tensor, pooled: torch.Tensor, stats: CacheStats):
    """Stage 3 — rank candidates, pick the final items -> (final, topk,
    stats')."""
    top, st = _rank(engine, batch, cand, u, pooled)
    picked = torch.gather(cand, 1, top.indices.clamp(min=0).long())
    final = torch.where(top.indices >= 0, picked, -1)
    return final, top, stats + st
