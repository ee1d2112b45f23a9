"""The frozen iMARS serving pipeline (`repro/serving/recsys_engine.py`).

Per batch, three stages (`serve_step`):

  1. `_lookup_stage`: the five user-feature bags and the mean-pooled
     history bag through the hot caches, then the filtering MLP -> u;
  2. `_scan_stage`: the LSH signature of u and the fixed-radius Hamming
     NNS over the item signatures (dense plan below `STREAM_MIN_ITEMS`
     rows, else the pruned streaming plan) -> candidates;
  3. `_rank_stage`: candidate rows through the hot cache, the genre bag
     through the int8 pool kernel, the ranking MLP, sigmoid and the
     threshold top-k -> final item ids.

The engine is a plain dataclass of tensors on one device. PyTorch runs
eagerly, so the stage functions are called directly (the reference jits
them). `ServeResult.cost` is None: the paper's cost model is not ported
yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.embedding import embedding_bag
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
from repro_torch.models import recsys as rs
from repro_torch.serving.catalog import (
    delta_cached_embedding_bag,
    delta_cached_rows,
)
from repro_torch.serving.hot_cache import (
    CacheStats,
    HotRowCache,
    build_hot_cache,
    cached_embedding_bag,
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
# the pipeline stages (batch tensors already on the engine's device)
# ---------------------------------------------------------------------------
def _features(engine: RecSysEngine, batch: dict):
    """Cached lookups + filtering DNN -> (u, pooled_history, CacheStats)."""
    valid = batch.get("valid")

    def mask(ids):
        if valid is None:
            return ids
        return torch.where(valid[:, None], ids, -1)

    stats = CacheStats.zero(engine.device)
    feats = []
    for name in sorted(engine.cfg.user_features.keys()):
        emb, st = cached_embedding_bag(
            engine.uiet_hot.get(name), engine.tables_q[name],
            mask(batch[name][:, None]))
        feats.append(emb)
        stats = stats + st
    pooled, st = delta_cached_embedding_bag(
        engine.delta, engine.item_hot, engine.item_table_q,
        mask(batch["history"]), mode="mean")
    stats = stats + st
    feats.append(pooled)
    x = torch.cat(feats, dim=-1)
    u = rs._mlp_apply(engine.params["filter_mlp"], x)
    return u, pooled, stats


def _nns(engine: RecSysEngine, q_sigs: torch.Tensor) -> NNSResult:
    """Filtering scan over the item signatures (local plan)."""
    if engine.delta is not None:
        raise NotImplementedError("live-catalog serving is not ported yet")
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
    """CTR + threshold top-k given precomputed user features."""
    valid = batch.get("valid")
    if valid is not None:  # padding rows: no candidate lookups, no stats
        cand = torch.where(valid[:, None], cand, -1)
    items, st = delta_cached_rows(engine.delta, engine.item_hot,
                                  engine.item_table_q, cand)
    genre = embedding_bag(engine.genre_table_q, batch["genre"][:, None])
    B, N = cand.shape
    ctx = torch.cat([u, genre, pooled], dim=-1)
    x = torch.cat([ctx[:, None].expand(B, N, ctx.shape[-1]), items], dim=-1)
    logits = rs._mlp_apply(engine.params["rank_mlp"], x)[..., 0]
    ctr = torch.sigmoid(logits)
    ctr = torch.where(cand >= 0, ctr, float("-inf"))
    return threshold_topk(ctr, threshold=0.0, k=engine.top_k), st


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
