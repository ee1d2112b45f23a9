"""The iMARS serving pipeline (`repro/serving/recsys_engine.py`).

Per batch, three stages (`serve_step`):

  1. `_lookup_stage`: the five user-feature bags and the mean-pooled
     history bag through the hot caches, in one launch of the grouped
     embedding-pool kernel that writes them straight into the filtering
     MLP's input, then the MLP -> u;
  2. `_scan_stage`: the LSH signature of u and the fixed-radius Hamming
     NNS over the item signatures (dense plan below `STREAM_MIN_ITEMS`
     rows, else the pruned streaming plan) -> candidates; a live engine
     also scans its delta shard densely and merges the two buffers;
  3. `_rank_stage`: the candidate rows through the hot cache and the genre
     bag, in one launch of the grouped pool kernel (the rows straight into
     the ranking MLP's input), the ranking MLP, sigmoid and the threshold
     top-k -> final item ids.

The engine is a plain dataclass of tensors on one device. PyTorch runs
eagerly, so the stage functions are called directly (the reference jits
them). `shard` spreads the filtering NNS over a `torch.distributed`
`DeviceMesh`: each rank keeps only its bank of the signatures, the
tombstone mask and the block summary (the item table stays replicated, as
in the reference), and the scan runs the mesh plans of `core.nns`. Every
rank makes the same calls (SPMD) and serves the same bits as the unsharded
engine. The two stages' pool plans (`kernels/ops.py:PoolPlan`: tables, hot
sets, side tables, modes and output columns) do not depend on the batch
and are built with the engine.

A frozen engine has `delta=None` and `item_mask=None`. A live engine
(`live()`, `serving/catalog.py`) carries a bounded delta shard of pending
item rows and the base rows' tombstone mask: the base scan masks the
tombstones, the delta scans dense and merges (`core.nns`), and the
history and candidate segments of the two pool launches resolve their
ids through the delta as their side table. An update or a compaction
builds a new engine (and new plans); the old one stays valid for the
buckets already queued on it.

The same three stages, dispatched one by one (`lookup_step`, `scan_step`,
`rank_stage_step`), are what the pipelined front-end
(`serving/async_server.py`) queues for each bucket. `serve` and the three
stages run inside `obs.span`s (`serve`, `serve.lookup`, `serve.scan`,
`serve.rank`), so a `torch.profiler` trace splits the device's time by
stage. Every `ServeResult` carries the paper's cost model for one query
(`query_cost`): the FeFET fabric's analytic latency and energy, not a
measurement of this device, computed once for each candidate count.
`hit_rate` is the YoutubeDNN HR@k evaluation in the paper's three
accuracy configurations.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import cost_model as cm
from repro_torch.core.lsh import lsh_signature
from repro_torch.core.nns import (
    NNSResult,
    build_block_summary,
    cosine_topk,
    delta_scan,
    fixed_radius_nns,
    merge_delta_candidates,
    query_parallel_delta_scan,
    query_parallel_nns,
    sharded_fixed_radius_nns,
)
from repro_torch.core.quantization import (
    QuantizedTensor,
    dequantize_rowwise,
    quantize_rowwise,
)
from repro_torch.core.topk import TopKResult, threshold_topk
from repro_torch.kernels import ops
from repro_torch.models import recsys as rs
from repro_torch.obs import span
from repro_torch.serving.hot_cache import (
    CacheStats,
    HotRowCache,
    build_hot_cache,
)
from repro_torch.utils import (
    bank_slice,
    mesh_axis_size,
    resolve_device,
    to_device,
)


class ServeResult(NamedTuple):
    items: torch.Tensor  # (B, top_k) final item ids, -1 padded
    topk: TopKResult  # per-candidate CTR top-k
    nns: NNSResult  # filtering-stage candidates
    cost: cm.OpCost  # the paper's cost model for one query
    stats: CacheStats  # hot-cache hits/lookups for this batch


@dataclasses.dataclass(frozen=True)
class RecSysEngine:
    """The deployed iMARS pipeline: int8 tables, item signatures, MLP
    weights and hot-row caches on one device, plus the serving knobs.

    ``scan_block``: None routes dense vs streaming by catalog size, 0
    forces dense, > 0 forces streaming. ``prune``: None prunes the
    streaming scan with ``block_summary``, False scans unpruned.
    ``nns_mesh`` / ``nns_axis`` / ``nns_query_axis``: set by `shard`; the
    NNS runs bank-sharded, query-parallel, or both. All are execution
    knobs only: every plan serves the same bits.
    """

    tables_q: dict  # name -> QuantizedTensor (int8 UIETs)
    item_table_q: QuantizedTensor  # int8 ItET
    genre_table_q: QuantizedTensor
    item_sigs: torch.Tensor  # (n_items, words) int32 packed signatures
    params: dict  # MLP weights (and the float tables they came from)
    lsh_proj: torch.Tensor  # (embed_dim, n_bits) f32
    item_hot: HotRowCache
    uiet_hot: dict  # name -> HotRowCache
    delta: object = None  # catalog.DeltaShard; None when frozen
    item_mask: torch.Tensor | None = None  # (n,) bool alive base rows
    block_summary: object = None  # core.nns.BlockSummary | None
    cfg: rs.YoutubeDNNConfig = None
    radius: int = 96
    n_candidates: int = 50
    top_k: int = 10
    scan_block: int | None = None
    prune: bool | None = None
    # set by `shard`: a torch.distributed DeviceMesh, the axis the
    # signature rows are banked over (this rank then holds one bank of
    # item_sigs, item_mask and block_summary) and the axis the queries are
    # blocked over
    nns_mesh: object = None
    nns_axis: str | None = None
    nns_query_axis: str | None = None
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

    def shard(self, mesh, axis: str | None = None, *,
              query_axis: str | None = None) -> "RecSysEngine":
        """Spread the filtering NNS over `mesh` (a `DeviceMesh` of the
        engine's device type; every rank calls this, and then serves, in
        the same order).

        `axis` banks the signature rows: they are padded to a multiple of
        the axis size (pad rows never match: `n_valid`, and dead in the
        mask) and this rank keeps only its bank of `item_sigs`,
        `item_mask` and the block summary. The summary is rebuilt over the
        bank's rows of the padded layout, or dropped when the bank size is
        not a multiple of its block rows (the banks then scan unpruned:
        same bits). `query_axis` blocks the query batch over a second
        axis, each block scanning its bank (or, without `axis`, the whole
        replicated catalog). `shard(mesh, "banks", query_axis="qp")`
        partitions (query block x bank).
        """
        if axis is None and query_axis is None:
            raise ValueError("shard() needs a db axis, a query_axis, or both")
        if self.nns_axis is not None:
            raise ValueError("shard() an unsharded engine: this one already "
                             "holds one bank")
        if mesh.device_type != self.device.type:
            raise ValueError(f"shard(): a {mesh.device_type} mesh for an "
                             f"engine on {self.device}")
        sigs, mask, summary = self.item_sigs, self.item_mask, \
            self.block_summary
        if axis is not None:
            n_banks = mesh_axis_size(mesh, axis)
            bank = mesh.get_local_rank(axis)
            n = sigs.shape[0]
            sigs = bank_slice(sigs, n_banks, bank)
            per_bank = sigs.shape[0]
            if mask is not None:  # pad rows stay dead
                mask = bank_slice(mask, n_banks, bank, fill=False)
            if summary is not None:
                br = summary.block_rows
                summary = (build_block_summary(
                    sigs, br, db_mask=mask,
                    n_valid=min(max(n - bank * per_bank, 0), per_bank))
                    if per_bank % br == 0 else None)
        return dataclasses.replace(
            self, item_sigs=sigs, item_mask=mask, block_summary=summary,
            nns_mesh=mesh, nns_axis=axis, nns_query_axis=query_axis)

    def live(self, delta_capacity: int = 1024) -> "RecSysEngine":
        """A live-catalog view: an empty delta shard of `delta_capacity`
        slots and an all-alive tombstone mask (`catalog.ensure_live`)."""
        from repro_torch.serving.catalog import ensure_live

        return ensure_live(self, delta_capacity)

    def apply_updates(self, upsert_ids=None, upsert_rows=None,
                      delete_ids=None) -> "RecSysEngine":
        """A new engine with the update batch in its delta shard
        (`catalog.engine_apply_updates`); this one stays valid."""
        from repro_torch.serving.catalog import engine_apply_updates

        return engine_apply_updates(self, upsert_ids, upsert_rows,
                                    delete_ids)

    def compact(self) -> "RecSysEngine":
        """A new-epoch engine with the delta folded into a fresh base
        (`catalog.compact_engine`); this one stays valid."""
        from repro_torch.serving.catalog import compact_engine

        return compact_engine(self)

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
        the NNS candidates, the paper's cost model for one query
        (`query_cost`) and this batch's CacheStats.
        """
        with span("serve"):
            items, top, nns, stats = serve_step(
                self, self.batch_to_device(batch),
                CacheStats.zero(self.device))
        return ServeResult(items=items, topk=top, nns=nns,
                           cost=self.query_cost(), stats=stats)

    def query_cost(self) -> cm.OpCost:
        """The iMARS fabric's latency and energy for one query, from the
        paper's analytic model (`cm.end_to_end_movielens`) at this engine's
        candidate count; not a measurement of this device."""
        return _modeled_cost(self.n_candidates)


@functools.cache
def _modeled_cost(n_candidates: int) -> cm.OpCost:
    """`RecSysEngine.query_cost`, computed once for each candidate count
    (an `OpCost` is frozen, so every engine may share it)."""
    e2e = cm.end_to_end_movielens(n_candidates=n_candidates)
    return cm.OpCost(latency_ns=e2e["imars_latency_us"] * 1e3,
                     energy_pj=e2e["imars_energy_uj"] * 1e6)


# ---------------------------------------------------------------------------
# the grouped-pool plans of the two stages
# ---------------------------------------------------------------------------
def _segment(table: QuantizedTensor, cache: HotRowCache | None, **kw):
    hot = cache is not None and cache.capacity > 0
    return ops.PoolSegment(
        values=table.values, scales=table.scales,
        hot_ids=cache.hot_ids if hot else None,
        hot_rows=cache.hot_rows if hot else None, **kw)


def _delta_side(engine: RecSysEngine) -> ops.SideTable | None:
    """The delta shard as the item segments' side table (None: frozen)."""
    delta = engine.delta
    if delta is None or delta.capacity == 0:
        return None
    return ops.SideTable(ids=delta.ids, values=delta.values,
                         scales=delta.scales)


def _lookup_plan(engine: RecSysEngine) -> ops.PoolPlan:
    """The sorted user features' bags, then the mean-pooled history, side
    by side in the filtering MLP's input (`_features`' concatenation); the
    history resolves its ids through the delta shard first."""
    segs, col = [], 0
    for name in sorted(engine.cfg.user_features):
        table = engine.tables_q[name]
        segs.append(_segment(table, engine.uiet_hot.get(name), mode="sum",
                             column=col, counted=True))
        col += table.values.shape[1]
    segs.append(_segment(engine.item_table_q, engine.item_hot, mode="mean",
                         column=col, counted=True, side=_delta_side(engine)))
    return ops.PoolPlan(segs)


def _rank_plan(engine: RecSysEngine) -> ops.PoolPlan:
    """The candidate rows (through the delta shard first) after the
    context [u, genre, pooled] in the ranking MLP's input, and the genre
    bag (no cache, no counters, and, as in the reference, read for padding
    rows too)."""
    ctx = (engine.params["filter_mlp"][-1]["b"].shape[0]
           + engine.genre_table_q.values.shape[1]
           + engine.item_table_q.values.shape[1])
    return ops.PoolPlan([
        _segment(engine.item_table_q, engine.item_hot, mode="rows",
                 column=ctx, counted=True, side=_delta_side(engine)),
        _segment(engine.genre_table_q, None, mode="sum", masked=False)])


# ---------------------------------------------------------------------------
# the pipeline stages (batch tensors already on the engine's device)
# ---------------------------------------------------------------------------
def _features(engine: RecSysEngine, batch: dict, sides=None):
    """Cached lookups + filtering DNN -> (u, pooled_history, CacheStats).

    One grouped-pool launch writes every bag into its columns of the MLP's
    input; padding rows (`valid` False) count no lookups and read zeros.
    `sides` (one side table or None a segment) replaces the segments' own
    for this batch: the tiered catalog's history overlay.
    """
    plan = engine.lookup_plan
    hist = batch["history"]
    names = sorted(engine.cfg.user_features)
    x = torch.empty((hist.shape[0], plan.width), dtype=torch.float32,
                    device=hist.device)
    counts = ops.grouped_pool(plan, [batch[n][:, None] for n in names]
                              + [hist], [x] * (len(names) + 1),
                              valid=batch.get("valid"), sides=sides)
    u = rs._mlp_apply(engine.params["filter_mlp"], x)
    col = plan.segments[-1].column
    pooled = x[:, col:col + engine.item_table_q.values.shape[1]]
    return u, pooled, CacheStats(hits=counts[0], lookups=counts[1])


def _nns(engine: RecSysEngine, q_sigs: torch.Tensor) -> NNSResult:
    """Filtering scan: the base through the engine's plan (bank-sharded,
    query-parallel or local) with tombstones masked; a live engine's delta
    shard scans dense (its queries blocked over the query axis, if any)
    and the two buffers merge into the rebuilt table's (distance, id)
    order."""
    mesh, n_items = engine.nns_mesh, engine.item_table_q.values.shape[0]
    kw = dict(scan_block=engine.scan_block, db_mask=engine.item_mask,
              summary=engine.block_summary, prune=engine.prune)
    if mesh is not None and engine.nns_axis is not None:
        base = sharded_fixed_radius_nns(
            mesh, engine.nns_axis, q_sigs, engine.item_sigs, engine.radius,
            engine.n_candidates, n_valid=n_items,
            query_axis=engine.nns_query_axis, **kw)
    elif mesh is not None:
        base = query_parallel_nns(
            mesh, engine.nns_query_axis, q_sigs, engine.item_sigs,
            engine.radius, engine.n_candidates, n_valid=n_items, **kw)
    else:
        base = fixed_radius_nns(q_sigs, engine.item_sigs, engine.radius,
                                engine.n_candidates, **kw)
    delta = engine.delta
    if delta is None or delta.capacity == 0:
        return base
    if mesh is not None and engine.nns_query_axis is not None:
        pending = query_parallel_delta_scan(
            mesh, engine.nns_query_axis, q_sigs, delta.sigs, delta.ids,
            engine.radius, engine.n_candidates)
    else:
        pending = delta_scan(q_sigs, delta.sigs, delta.ids, engine.radius,
                             engine.n_candidates)
    return merge_delta_candidates(base, pending, engine.n_candidates)


def filter_step(engine: RecSysEngine, batch: dict):
    """Features + filtering NNS -> (NNSResult, stats)."""
    u, _, stats = _features(engine, batch)
    return _nns(engine, lsh_signature(u, engine.lsh_proj)), stats


def _rank(engine: RecSysEngine, batch: dict, cand: torch.Tensor,
          u: torch.Tensor, pooled: torch.Tensor, sides=None):
    """CTR + threshold top-k given precomputed user features.

    One grouped-pool launch writes the candidate rows into the ranking
    MLP's input (padding rows and -1 candidates read zeros and count no
    lookups) and pools the genre bag; the context fills the rest. `sides`
    as in `_features` (the tiered catalog's candidate overlay).
    """
    plan = engine.rank_plan
    valid = batch.get("valid")
    cand = cand.contiguous()
    B, N = cand.shape
    x = torch.empty((B, N, plan.width), dtype=torch.float32,
                    device=cand.device)
    genre = torch.empty((B, engine.genre_table_q.values.shape[1]),
                        dtype=torch.float32, device=cand.device)
    counts = ops.grouped_pool(plan, [cand, batch["genre"][:, None]],
                              [x, genre], valid=valid, sides=sides)
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
    with span("serve.lookup"):
        u, pooled, st = _features(engine, batch)
        return u, pooled, stats + st


def _scan_stage(engine: RecSysEngine, u: torch.Tensor) -> NNSResult:
    """Stage 2 — LSH-sign u and run the filtering NNS."""
    with span("serve.scan"):
        return _nns(engine, lsh_signature(u, engine.lsh_proj))


def _rank_stage(engine: RecSysEngine, batch: dict, cand: torch.Tensor,
                u: torch.Tensor, pooled: torch.Tensor, stats: CacheStats,
                sides=None):
    """Stage 3 — rank candidates, pick the final items -> (final, topk,
    stats')."""
    with span("serve.rank"):
        top, st = _rank(engine, batch, cand, u, pooled, sides)
        picked = torch.gather(cand, 1, top.indices.clamp(min=0).long())
        final = torch.where(top.indices >= 0, picked, -1)
        return final, top, stats + st


# the pipeline split at its stage boundaries, for pipelined serving
# (serving/async_server.py): lookup -> scan -> rank compose to exactly
# serve_step, each dispatched on its own so a driver can queue a bucket's
# three stages and stage the next bucket on the host meanwhile
lookup_step = _lookup_stage
scan_step = _scan_stage
rank_stage_step = _rank_stage


def n_summary_blocks(engine: RecSysEngine) -> int:
    """Total block-summary blocks of the engine's catalog (0 when no
    summary is attached — dense plans can't prune). The denominator for
    the ``scan_frac`` telemetry: blocks touched / summary blocks."""
    summary = engine.block_summary
    return 0 if summary is None else int(summary.n_blocks)


def hit_rate(engine: RecSysEngine, data, batch_size: int = 256,
             k: int = 10, mode: str = "lsh", max_users: int | None = None
             ) -> float:
    """YoutubeDNN leave-one-out HR@k over the test labels.

    mode: "fp32" (cosine, fp32 tables), "int8" (cosine over dequantized
    int8), "lsh" (the iMARS fixed-radius Hamming path) — the three accuracy
    configurations of paper Sec. IV-B.

    Users are chunked into fixed `batch_size` batches (the last chunk
    padded with its last user, its extra rows dropped), as the reference
    does, and each chunk goes through one `_hr_step`.
    """
    n = data.n_users if max_users is None else min(max_users, data.n_users)
    hits = 0
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        idx = np.arange(lo, hi)
        pad_idx = np.concatenate(
            [idx, np.full(batch_size - idx.size, idx[-1], idx.dtype)])
        batch = engine.batch_to_device({
            **{k2: v[pad_idx] for k2, v in data.user_feats.items()},
            "history": data.histories[pad_idx],
            "genre": data.genres[pad_idx]})
        got = _hr_step(engine, batch, mode, k).cpu().numpy()[: idx.size]
        labels = data.test_labels[idx]
        hits += int((got == labels[:, None]).any(axis=1).sum())
    return hits / n


def _hr_step(engine: RecSysEngine, batch: dict, mode: str, k: int):
    """Top-k retrieved item ids (B, k) for one padded batch."""
    if mode == "fp32":
        u = rs.user_tower(engine.params, engine.cfg, batch)
        _, top = cosine_topk(u, engine.params["item_table"], k)
        return top
    if mode == "int8":
        u, _, _ = _features(engine, batch)
        _, top = cosine_topk(u, dequantize_rowwise(engine.item_table_q), k)
        return top
    if mode != "lsh":
        raise ValueError(f"hit_rate: mode {mode!r} (fp32, int8 or lsh)")
    nns, _ = filter_step(engine, batch)
    return nns.indices[:, :k]
