"""Open-loop load generation: Poisson arrivals, Zipf popularity, bursts.

A copy of `repro/serving/load_gen.py` (numpy only): the same arguments give
the same schedule as the reference.

Closed-loop benchmarks (serve a wave, wait, serve the next) can only
measure *peak* throughput: the client politely stops offering load while
the server works, so queueing latency never appears. Production traffic
is open-loop — users arrive whether or not the tier is keeping up — and
the number that says "millions of users" is the latency-vs-offered-load
curve, not peak qps. This module generates that load:

  * **Poisson arrivals** per tenant at a configured offered rate
    (exponential inter-arrivals — the datacenter arrival model);
  * **Zipf query popularity** — query ids drawn ``p(rank) ∝ rank^-a``
    from a finite pool, the heavily skewed production embedding traffic
    RecNMP documents (and what makes the hot-row cache earn its keep);
  * **bursty phases** — a deterministic on/off rate modulation
    ``(period_s, duty_frac, multiplier)`` realized by thinning a peak-rate
    Poisson stream, so bursts are still a (inhomogeneous) Poisson process;
  * **real-time replay** into any `Server` — arrivals are submitted at
    their scheduled wall-clock offsets even when the server is behind
    (that is the open loop); latency is measured by the front-end's own
    submit/resolve timestamps (`ConcurrentFrontend.take_trace`), not by
    the caller's redemption time.

Everything is seeded and the schedule is generated up front, so the same
(seed, rate, duration) always offers the same queries at the same
offsets — the CI smoke lane depends on that determinism.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from repro_torch.serving.server import (
    STATUS_OK,
    STATUS_SHED,
    ServerConfigError,
)


@dataclasses.dataclass(frozen=True)
class LoadSummary:
    """Per-tenant and aggregate outcome of one open-loop run."""

    duration_s: float
    offered_qps: float  # scheduled arrivals / duration
    achieved_qps: float  # status=ok completions / duration
    shed_frac: float  # shed / submitted
    error_frac: float  # errors / submitted
    p50_ms: float  # admitted (ok) latency percentiles, submit -> resolve
    p99_ms: float
    per_tenant: dict  # tenant -> {offered_qps, achieved_qps, shed_frac,
    #                              p50_ms, p99_ms, n_ok, n_shed, n_errors}


def summarize_trace(trace: Sequence, duration_s: float) -> LoadSummary:
    """Fold `TicketTrace` records into a `LoadSummary`.

    Latency percentiles cover **admitted** (status="ok") tickets only —
    shed tickets resolve instantly by design and would fake a great p99;
    their cost is accounted as `shed_frac` instead.
    """
    tenants = sorted({r.tenant for r in trace})
    per_tenant = {}
    for t in tenants:
        rs = [r for r in trace if r.tenant == t]
        lat = np.array([r.latency_s for r in rs if r.status == STATUS_OK])
        n_ok = int(len(lat))
        n_shed = sum(r.status == STATUS_SHED for r in rs)
        p50, p99 = (np.percentile(lat, [50, 99]) * 1e3 if n_ok else
                    (float("nan"), float("nan")))
        per_tenant[t] = {
            "offered_qps": len(rs) / duration_s,
            "achieved_qps": n_ok / duration_s,
            "shed_frac": n_shed / len(rs) if rs else 0.0,
            "p50_ms": float(p50), "p99_ms": float(p99),
            "n_ok": n_ok, "n_shed": int(n_shed),
            "n_errors": int(len(rs) - n_ok - n_shed),
        }
    lat = np.array([r.latency_s for r in trace if r.status == STATUS_OK])
    n = len(trace)
    n_ok, n_shed = len(lat), sum(r.status == STATUS_SHED for r in trace)
    p50, p99 = (np.percentile(lat, [50, 99]) * 1e3 if n_ok else
                (float("nan"), float("nan")))
    return LoadSummary(
        duration_s=duration_s,
        offered_qps=n / duration_s,
        achieved_qps=n_ok / duration_s,
        shed_frac=n_shed / n if n else 0.0,
        error_frac=(n - n_ok - n_shed) / n if n else 0.0,
        p50_ms=float(p50), p99_ms=float(p99),
        per_tenant=per_tenant)


class LoadGen:
    """Deterministic open-loop arrival schedule + real-time replayer.

    Args:
      rate_qps: total offered rate, split evenly across tenants.
      duration_s: schedule horizon.
      tenants: tenant count (ids ``0..tenants-1``, matching
        `ConcurrentFrontend`).
      pool_size: number of distinct queries to draw from (the caller
        provides the actual query dicts at replay time).
      zipf_a: Zipf popularity exponent over the pool (0 = uniform).
      burst: optional ``(period_s, duty_frac, multiplier)`` — for the
        first ``duty_frac`` of every ``period_s`` window the offered rate
        is ``multiplier`` x the base rate (thinned peak-rate Poisson, so
        the average offered rate rises accordingly).
      seed: RNG seed; the schedule is a pure function of the arguments.
    """

    def __init__(self, *, rate_qps: float, duration_s: float,
                 tenants: int = 1, pool_size: int,
                 zipf_a: float = 1.1,
                 burst: tuple[float, float, float] | None = None,
                 seed: int = 0):
        if rate_qps <= 0 or duration_s <= 0:
            raise ServerConfigError("rate_qps and duration_s must be > 0")
        if tenants < 1 or pool_size < 1:
            raise ServerConfigError("tenants and pool_size must be >= 1")
        if burst is not None:
            period, duty, mult = burst
            if not (period > 0 and 0 < duty <= 1 and mult >= 1):
                raise ServerConfigError(
                    f"burst must be (period>0, 0<duty<=1, mult>=1): {burst}")
        self.rate_qps = float(rate_qps)
        self.duration_s = float(duration_s)
        self.tenants = int(tenants)
        self.pool_size = int(pool_size)
        self.zipf_a = float(zipf_a)
        self.burst = burst
        self.seed = int(seed)

    # ------------------------------------------------------------------
    def _zipf_p(self) -> np.ndarray:
        ranks = np.arange(1, self.pool_size + 1, dtype=np.float64)
        p = ranks ** -self.zipf_a
        return p / p.sum()

    def schedule(self) -> list[tuple[float, int, int]]:
        """Sorted ``(t_offset_s, tenant, pool_index)`` arrivals.

        Per-tenant independent Poisson streams at ``rate_qps / tenants``;
        bursts realized by thinning a peak-rate stream so the process
        stays Poisson within each phase.
        """
        rng = np.random.default_rng(self.seed)
        per_rate = self.rate_qps / self.tenants
        peak = per_rate * (self.burst[2] if self.burst else 1.0)
        p_pool = self._zipf_p()
        out = []
        for tenant in range(self.tenants):
            # draw enough exponential gaps to cover the horizon at peak
            n_max = max(16, int(peak * self.duration_s * 1.5) + 64)
            t = np.cumsum(rng.exponential(1.0 / peak, size=n_max))
            while t[-1] < self.duration_s:  # pragma: no cover - rare topup
                t = np.concatenate(
                    [t, t[-1] + np.cumsum(
                        rng.exponential(1.0 / peak, size=n_max))])
            t = t[t < self.duration_s]
            if self.burst is not None:
                period, duty, mult = self.burst
                in_burst = (t % period) < duty * period
                # thin off-burst arrivals down from the peak rate
                keep = in_burst | (rng.random(len(t)) < 1.0 / mult)
                t = t[keep]
            q = rng.choice(self.pool_size, size=len(t), p=p_pool)
            out.extend(zip(t.tolist(), [tenant] * len(t), q.tolist()))
        out.sort()
        return out

    # ------------------------------------------------------------------
    def replay(self, server, pool: Sequence[dict]
               ) -> list[tuple[int, int, int]]:
        """Submit the schedule against `server` in real time.

        Arrivals are submitted at their scheduled offsets; when the
        submitting thread falls behind wall-clock (scheduler jitter, a
        slow submit), the overdue arrivals are submitted immediately —
        open-loop load never waits for the server. Returns
        ``(ticket, tenant, pool_index)`` in schedule order (so callers
        can bit-match admitted results against synchronous serving);
        call ``server.flush()`` + ``server.take_trace()`` afterwards to
        measure.
        """
        if len(pool) < self.pool_size:
            raise ServerConfigError(
                f"pool has {len(pool)} queries, schedule draws from "
                f"{self.pool_size}")
        sched = self.schedule()
        out = []
        t0 = time.perf_counter()
        for t_arr, tenant, qi in sched:
            lag = t_arr - (time.perf_counter() - t0)
            if lag > 0:
                time.sleep(lag)
            out.append((server.submit(pool[qi], tenant=tenant), tenant, qi))
        return out
