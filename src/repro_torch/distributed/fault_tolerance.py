"""Fault-tolerant training loop: checkpoint/restart, per-step retry,
straggler detection, fault injection for tests (mirrors
`repro/distributed/fault_tolerance.py`).

A dead process kills the step; the job restarts, `TrainLoop` resumes from
the last committed checkpoint (`checkpoint/checkpointer.py`: atomic,
checksummed), and the run continues bit for bit where the step itself is
deterministic. One device: the reference's resharding on restore
(`shardings`) waits for the port's multi-GPU plans.

A step flagged as a straggler (slower than `straggler_factor` times the
moving average of step times) skips the checkpoint due on it, as in the
reference; a restart then resumes from the checkpoint before. Runs that
must resume from a known step use ``straggler_factor=float("inf")``.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Iterator

from repro_torch.checkpoint.checkpointer import Checkpointer

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class FaultPolicy:
    max_retries_per_step: int = 2
    checkpoint_every: int = 50
    straggler_factor: float = 3.0  # step slower than EMA*factor -> straggler
    ema_alpha: float = 0.2


@dataclasses.dataclass
class StepRecord:
    step: int
    metrics: dict
    duration_s: float
    retries: int = 0
    straggler: bool = False


class TrainLoop:
    """Drives train_step with checkpoint/restart + retry + straggler log.

    train_step: ``(state, batch) -> (state', metrics dict)``; each metric
    is read to a float on the host after its step (the step's only sync).
    fault_hook: optional callable(step) raising to simulate failures (used
    by tests; on real hardware this is where preemption signals surface).
    """

    def __init__(
        self,
        train_step: Callable[[Any, dict], tuple[Any, dict]],
        checkpointer: Checkpointer,
        policy: FaultPolicy = FaultPolicy(),
        fault_hook: Callable[[int], None] | None = None,
    ):
        self.train_step = train_step
        self.ckpt = checkpointer
        self.policy = policy
        self.fault_hook = fault_hook
        self.records: list[StepRecord] = []
        self.straggler_events: list[int] = []
        self._ema: float | None = None

    def resume_or_init(self, init_state_fn: Callable[[], Any]):
        """(state, start step) from the latest committed checkpoint, or
        (a fresh state, 0). A fresh state from `init_state_fn` is the
        template the checkpoint restores into (structure and devices)."""
        fresh = init_state_fn()
        step, state = self.ckpt.restore_latest(fresh)
        if state is None:
            log.info("no checkpoint found; initializing fresh state")
            return fresh, 0
        log.info("resumed from checkpoint step %d", step)
        return state, int(step)

    def run(self, state: Any, data: Iterator[dict], n_steps: int,
            start_step: int = 0):
        step = start_step
        it = iter(data)
        while step < n_steps:
            batch = next(it)
            retries = 0
            while True:
                try:
                    if self.fault_hook is not None:
                        self.fault_hook(step)
                    t0 = time.monotonic()
                    state, metrics = self.train_step(state, batch)
                    metrics = {k: float(v) for k, v in metrics.items()}
                    dt = time.monotonic() - t0
                    break
                except _TRANSIENT as e:
                    retries += 1
                    if retries > self.policy.max_retries_per_step:
                        # unrecoverable on this incarnation: persist and die;
                        # the restart path picks up from the last checkpoint
                        self.ckpt.wait()
                        raise
                    log.warning("step %d failed (%s); retry %d",
                                step, e, retries)

            straggler = False
            if self._ema is not None and dt > self.policy.straggler_factor \
                    * self._ema:
                straggler = True
                self.straggler_events.append(step)
                # mitigation: defer non-critical work (metrics flush /
                # checkpoint) out of the slow step's shadow
                log.warning("straggler step %d: %.3fs vs EMA %.3fs",
                            step, dt, self._ema)
            self._ema = dt if self._ema is None else (
                self.policy.ema_alpha * dt
                + (1 - self.policy.ema_alpha) * self._ema)

            self.records.append(StepRecord(step=step, metrics=metrics,
                                           duration_s=dt, retries=retries,
                                           straggler=straggler))
            step += 1
            if step % self.policy.checkpoint_every == 0 and not straggler:
                self.ckpt.save(step, state)
        self.ckpt.save(step, state)
        self.ckpt.wait()
        return state, step


class SimulatedTransientFailure(RuntimeError):
    pass


_TRANSIENT = (SimulatedTransientFailure,)
