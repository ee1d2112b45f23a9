"""Train-while-serve: filtering-model gradient steps feeding the live
catalog (mirrors `repro/serving/online.py`).

`OnlineTrainer` keeps the catalog fresh while traffic is live:

  * **gradient steps** run the offline training computation
    (`distributed.training.make_recsys_train_step`: full-softmax
    `filtering_loss` + AdamW) on interaction batches;
  * **embedding folds** diff the trainer's item table against the last
    published one and push only the changed rows through
    `LiveCatalog.upsert`, the quantize-at-ingestion path, so a folded row
    is bit-identical to the same row of a cold `RecSysEngine.build` of
    the current parameters;
  * **dense refreshes** (`refresh_dense`) publish the MLPs, feature
    tables and genre table through `LiveCatalog.refresh_model`;
  * every publication goes through the catalog to `server.swap_engine`,
    which on the concurrent front-end takes the drain thread's serve
    lock: a drain chunk is served by one engine, and nothing a queued
    bucket reads is changed.

The trainer owns its parameters. It clones them at construction, and its
step and AdamW are out of place, so a published engine never holds a
tensor that a later step writes: an engine serves exactly what it was
published with until the next fold or refresh replaces it.

Staleness contract (measured): each `step()` *lands* one update batch in
trainer state at t_step; a later `fold()` makes it *visible* to serving at
t_fold. Per-batch staleness is ``t_fold - t_step``; `updates_landed` /
`updates_visible` count the two sides, and `staleness_ms` keeps every
folded batch's value.

Single writer: call `step` / `fold` / `refresh_dense` from one thread
(the training thread). Serving threads only read engines that
publications swapped in. The correctness oracle is `serving/shadow.py`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.distributed import training
from repro_torch.serving.catalog import LiveCatalog
from repro_torch.utils import to_device, tree_map


class OnlineTrainer:
    """Filtering-model online learner over a `LiveCatalog`.

    Args:
      catalog: the live catalog whose attached servers receive every fold
        and refresh (`LiveCatalog.attach` wires the publication path).
      cfg: the `YoutubeDNNConfig` the catalog's engine was built with.
      params: the current model parameters (the engine's build
        parameters: online learning continues the deployed model). They
        are copied onto the engine's device; the caller's stay as given.
      lr / weight_decay: AdamW knobs, the offline recipe's defaults.
      fold_every: publish embedding updates every N steps (1 = every
        step; 0 = only on explicit `fold()` calls).
      compact_every: fold the delta into a new base epoch every N folds
        (0 = never; the delta still compacts itself when full).
    """

    def __init__(self, catalog: LiveCatalog, cfg, params, *,
                 lr: float = 3e-3, weight_decay: float = 0.0,
                 fold_every: int = 1, compact_every: int = 0):
        self.catalog = catalog
        self.cfg = cfg
        self.fold_every = int(fold_every)
        self.compact_every = int(compact_every)
        device = catalog.engine.device
        own = tree_map(torch.clone, to_device(params, device))
        self.state = training.init_recsys_train_state(own, device)
        self._train_step = training.make_recsys_train_step(
            cfg, lr=lr, weight_decay=weight_decay)
        # the last *published* item table (host f32): folds diff against
        # it so only rows whose embedding moved ride the delta
        self._last_folded = own["item_table"].to(torch.float32).cpu(
            ).numpy().copy()
        self.steps_done = 0
        self.n_folds = 0
        self.rows_folded = 0
        self.updates_visible = 0  # steps whose updates serving can see
        self.staleness_ms: list[float] = []  # one entry per folded step
        self._pending_t: list[float] = []  # t_step of not-yet-folded steps
        self.last_loss = float("nan")
        # telemetry: share the catalog's registry (adopted from the
        # attached server) so fold staleness rides the one snapshot();
        # resolved lazily because attach order varies
        self._registry = None
        self._probe_registry()

    @property
    def registry(self):
        return self._probe_registry()

    def _probe_registry(self):
        """The catalog's registry, once it has one; registers the
        `online.*` collector the first time it appears."""
        if self._registry is None:
            reg = getattr(self.catalog, "registry", None)
            if reg is not None:
                self._registry = reg
                reg.register_collector(self._collect)
        return self._registry

    def _collect(self, reg) -> None:
        """Snapshot-time collector: `online.*` freshness gauges."""
        reg.gauge("online.steps", self.steps_done)
        reg.gauge("online.folds", self.n_folds)
        reg.gauge("online.rows_folded", self.rows_folded)
        reg.gauge("online.updates_visible", self.updates_visible)
        reg.gauge("online.updates_pending", self.updates_pending)

    # -- introspection -------------------------------------------------
    @property
    def params(self):
        """The trainer's current parameters (the cold-rebuild input)."""
        return self.state.params

    @property
    def updates_landed(self) -> int:
        """Update batches applied to trainer state (== steps taken)."""
        return self.steps_done

    @property
    def updates_pending(self) -> int:
        """Landed update batches not yet visible to serving."""
        return self.steps_done - self.updates_visible

    # -- the training loop ---------------------------------------------
    def step(self, batch: dict) -> float:
        """One gradient step on an interaction batch; folds on cadence.

        Returns the batch loss (read to the host: the step's one sync).
        The step *lands* an update batch: its embedding changes exist only
        in trainer state until the next fold makes them serveable.
        """
        self.state, loss = self._train_step(self.state, batch)
        self.last_loss = float(loss)
        self.steps_done += 1
        self._pending_t.append(time.perf_counter())
        if self.fold_every and self.steps_done % self.fold_every == 0:
            self.fold()
        return self.last_loss

    def fold(self) -> int:
        """Publish item-embedding changes since the last fold.

        Diffs the trainer's item table against the last published one and
        upserts exactly the changed rows (quantized at ingestion,
        `LiveCatalog.upsert`); the publication swaps the new engine into
        every attached server under its serve lock. Returns the number of
        rows folded; with no pending change there is no upsert and no
        publication.
        """
        table = self.state.params["item_table"].to(torch.float32).cpu(
            ).numpy()
        changed = np.nonzero((table != self._last_folded).any(axis=1))[0]
        if changed.size:
            self.catalog.upsert(changed.astype(np.int64), table[changed])
            self._last_folded[changed] = table[changed]
            self.rows_folded += int(changed.size)
        now = time.perf_counter()
        self.staleness_ms.extend((now - t) * 1e3 for t in self._pending_t)
        if self.registry is not None:
            for t in self._pending_t:
                self.registry.observe("online.staleness_ms",
                                      (now - t) * 1e3)
            self.registry.event("fold", rows=int(changed.size),
                                steps_folded=len(self._pending_t))
        self.updates_visible += len(self._pending_t)
        self._pending_t.clear()
        self.n_folds += 1
        if self.compact_every and self.n_folds % self.compact_every == 0:
            self.catalog.compact()
        return int(changed.size)

    def refresh_dense(self) -> None:
        """Publish the current dense parameters (MLPs, feature tables,
        genre table) to serving: `LiveCatalog.refresh_model`. After
        ``fold(); refresh_dense()`` the live engine serves bit for bit
        what a cold rebuild of `self.params` serves (`serving.shadow`).
        The published tensors are this state's; the next step makes new
        ones and leaves them as they are."""
        self.catalog.refresh_model(self.state.params)

    def stats(self) -> dict:
        """Host-side freshness counters (never affect served results)."""
        lat = self.staleness_ms
        return {
            "steps": self.steps_done,
            "folds": self.n_folds,
            "rows_folded": self.rows_folded,
            "updates_landed": self.updates_landed,
            "updates_visible": self.updates_visible,
            "updates_pending": self.updates_pending,
            "staleness_ms_mean": float(np.mean(lat)) if lat else 0.0,
            "staleness_ms_p95": float(np.percentile(lat, 95)) if lat
            else 0.0,
            "last_loss": self.last_loss,
        }
