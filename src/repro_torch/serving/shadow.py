"""Shadow serving: the freshness oracle for train-while-serve (mirrors
`repro/serving/shadow.py`).

The live path (`serving/online.py`) folds embedding updates into a serving
engine incrementally: delta shard, tombstones, dense refreshes. To prove
those mechanics never cost recommendation quality, shadow them with the
path that has no mechanics: a *cold rebuild* of the trainer's current
parameters, quantized from scratch like a first deployment.

  * `rebuild_from_params(engine, params)`: the parameter-level cold
    oracle. Every table re-quantizes with the build-time transform, the
    item signatures are recomputed over the dequantized rows with the live
    engine's LSH projection, the block summary is built cold, and the hot
    caches re-pin the live engine's pinned sets (bit-transparent either
    way). Same fields and shapes as the live engine.
  * `ShadowHarness`: replays one seeded eval stream (the dataset's
    leave-one-out users) against the live engine and the cold rebuild at
    every checkpoint, asserts that HR@k agrees within `tol`, and records
    the trainer's staleness between checkpoints.

Checkpoint contract: `checkpoint()` first makes every landed update
visible (``trainer.fold(); trainer.refresh_dense()``), so live and shadow
serve the same model and any HR gap is a fault of the serving-side
machinery, not of the optimizer. Between checkpoints the live path really
is stale (the measured axis).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.lsh import lsh_signature
from repro_torch.core.nns import EMPTY_ID, build_block_summary
from repro_torch.core.quantization import dequantize_rowwise, quantize_rowwise
from repro_torch.serving.catalog import empty_delta
from repro_torch.serving.hot_cache import pin_rows
from repro_torch.serving.recsys_engine import filter_step, hit_rate
from repro_torch.utils import to_device


def rebuild_from_params(engine, params):
    """A frozen from-scratch engine over `params` with `engine`'s knobs.

    The cold-deployment image of the trainer's current model on the
    engine's device: the item, feature and genre tables quantize row-wise
    from scratch, the item signatures are recomputed over the dequantized
    int8 rows with the live engine's LSH projection, the block summary is
    built cold, the delta is empty (of the live capacity) and every base
    row is alive. The hot caches pin the live engine's current pinned ids
    over the fresh tables (the cache is bit-transparent; pinning the same
    set keeps `CacheStats` comparable too). Always unsharded.
    """
    params = to_device(params, engine.device)
    item_q = quantize_rowwise(params["item_table"].to(torch.float32))
    sigs = lsh_signature(dequantize_rowwise(item_q), engine.lsh_proj)
    tables_q = {k: quantize_rowwise(v) for k, v in params["tables"].items()}
    n, d = item_q.values.shape

    def repin(cache, table):
        if cache is None or not cache.capacity:
            return cache
        ids = cache.hot_ids.cpu().numpy()
        return pin_rows(table, ids[ids != EMPTY_ID], cache.capacity)

    cap = engine.delta.capacity if engine.delta is not None else 0
    summary = (build_block_summary(sigs) if engine.block_summary is None
               else build_block_summary(sigs,
                                        engine.block_summary.block_rows))
    return dataclasses.replace(
        engine, params=params, item_table_q=item_q, item_sigs=sigs,
        tables_q=tables_q,
        genre_table_q=quantize_rowwise(params["genre_table"]),
        item_hot=repin(engine.item_hot, item_q),
        uiet_hot={k: repin(c, tables_q[k])
                  for k, c in engine.uiet_hot.items()},
        item_mask=torch.ones((n,), dtype=torch.bool, device=engine.device),
        block_summary=summary,
        delta=empty_delta(cap, d, sigs.shape[1], engine.device),
        nns_mesh=None, nns_axis=None, nns_query_axis=None)


class ShadowRecord(NamedTuple):
    """One shadow checkpoint: live vs cold-rebuilt quality + freshness."""

    step: int  # trainer steps at eval time
    hr_live: float  # HR@k of the continuously-updated live engine
    hr_ref: float  # HR@k of the cold rebuild of the current params
    gap: float  # abs(hr_live - hr_ref), asserted <= tol
    agree_frac: float  # top-k retrieval agreement on the probe batch
    staleness_ms: float  # mean staleness of steps folded since last eval
    eval_s: float  # wall time of this checkpoint (both evals)


class ShadowHarness:
    """Replays a seeded eval stream against live and shadow engines.

    Args:
      trainer: the `OnlineTrainer` under test (its catalog's engine is
        the live side; its params feed the cold rebuild).
      data: the `MovieLensSynth` dataset: the seeded query stream and
        leave-one-out labels (`recsys_engine.hit_rate`).
      k / mode: HR@k configuration (mode="lsh" is the iMARS path).
      tol: max allowed ``abs(hr_live - hr_ref)`` per checkpoint.
      max_users: cap the eval stream (None = every user).
      probe_batch: users in the retrieval-agreement probe (0 disables).

    `checkpoint()` raises `AssertionError` when the live path's quality
    leaves the tolerance band, after recording the failing checkpoint.
    """

    def __init__(self, trainer, data, *, k: int = 10, mode: str = "lsh",
                 tol: float = 0.01, max_users: int | None = None,
                 probe_batch: int = 256):
        self.trainer = trainer
        self.data = data
        self.k = int(k)
        self.mode = mode
        self.tol = float(tol)
        self.max_users = max_users
        self.probe_batch = min(int(probe_batch), data.n_users)
        self.records: list[ShadowRecord] = []
        self._staleness_lo = 0  # trainer.staleness_ms cursor

    def _probe_agreement(self, live, ref) -> float:
        """Fraction of top-k retrieved ids both engines agree on, position
        by position, over one fixed probe batch (`filter_step` on the
        engines' device)."""
        if not self.probe_batch:
            return 1.0
        idx = np.arange(self.probe_batch)
        batch = live.batch_to_device({
            **{kk: v[idx] for kk, v in self.data.user_feats.items()},
            "history": self.data.histories[idx],
            "genre": self.data.genres[idx]})
        got = filter_step(live, batch)[0].indices[:, : self.k].cpu().numpy()
        want = filter_step(ref, batch)[0].indices[:, : self.k].cpu().numpy()
        return float((got == want).mean())

    def checkpoint(self) -> ShadowRecord:
        """Sync the live path, evaluate both sides, record, assert the gap.

        Folds pending updates and refreshes the dense parameters first:
        the checkpoint compares the current model served incrementally
        against the current model served from a cold rebuild.
        """
        t0 = time.perf_counter()
        t = self.trainer
        t.fold()
        t.refresh_dense()
        live = t.catalog.engine
        ref = rebuild_from_params(live, t.params)
        hr_live = hit_rate(live, self.data, k=self.k, mode=self.mode,
                           max_users=self.max_users)
        hr_ref = hit_rate(ref, self.data, k=self.k, mode=self.mode,
                          max_users=self.max_users)
        gap = abs(hr_live - hr_ref)
        lat = t.staleness_ms[self._staleness_lo:]
        self._staleness_lo = len(t.staleness_ms)
        rec = ShadowRecord(
            step=t.steps_done, hr_live=hr_live, hr_ref=hr_ref, gap=gap,
            agree_frac=self._probe_agreement(live, ref),
            staleness_ms=float(np.mean(lat)) if lat else 0.0,
            eval_s=time.perf_counter() - t0)
        self.records.append(rec)
        if gap > self.tol:
            raise AssertionError(
                f"shadow checkpoint at step {t.steps_done}: live HR@{self.k}"
                f" {hr_live:.4f} vs cold-rebuilt {hr_ref:.4f} — gap "
                f"{gap:.4f} exceeds tol {self.tol}")
        return rec
