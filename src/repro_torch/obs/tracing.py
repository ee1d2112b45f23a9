"""Per-request stage spans: the ticket lifecycle as host timestamps.

A copy of `repro/obs/tracing.py`, and `span`, which is the port's own.

iMARS Fig. 3 is a *pipeline*: lookups feed the filtering NNS which feeds
the ranking crossbars, and the paper's claims are per-stage latency
breakdowns. The serving tier mirrors that pipeline in software, so every
ticket — in all three `make_server` modes, including shed and error
outcomes — carries a **span chain**: ``((stage, t), ...)`` with
`time.perf_counter()` timestamps at each lifecycle boundary, ordered by
`STAGES`:

    submit    the caller handed the query in
    admit     the admission decision (== submit for the single-tenant
              front-ends; shed tickets stop here and jump to resolve)
    bucket    the query left its queue and was assigned a batch bucket
    dispatch  the jitted stage pipeline was dispatched to the device
    scan      the filtering NNS scan completed (sync mode observes the
              real device boundary through an event recorded between the
              scan and the rank stage, once both are queued; pipelined
              mode retires scan+rank together at the ring sync, so scan
              carries the whole device wait and rank is ~0 there)
    rank      the ranked items were materialized on the host
    resolve   the ticket's result was recorded / redeemable

A chain is *contiguous*: stage i starts where stage i-1 ended, so the sum
of stage durations equals ``done_s - submit_s`` exactly — the property
`benchmarks/obs_overhead.py` gates (stage sum within 10% of measured
ticket latency) and `tools/obs_report.py` renders as a breakdown table.

A chain may be a **subsequence** of `STAGES` (shed: submit/admit/resolve;
error: submit/admit/resolve) but is always non-empty when tracing is on,
starts at ``submit``, ends at ``resolve``, and is non-decreasing in time
(`well_ordered` checks all of it; tested in tests/test_obs.py).

Inside the serve step the port names its work with `span`: nested ranges
on the host thread (`serve` > `serve.lookup` / `serve.scan` / `serve.rank`,
`nns.dense` > `nns.dense.select`, `nns.stream` > `nns.stream.bounds`).
They are `torch.profiler.record_function` ranges while a profiler records,
so the profiler links every device operation to the span it was launched
in, and one shared no-op context otherwise (one check a span).
"""
from __future__ import annotations

import contextlib
import json
from typing import NamedTuple

import torch

# canonical stage order; every span chain's names are a subsequence
STAGES = ("submit", "admit", "bucket", "dispatch", "scan", "rank",
          "resolve")
_STAGE_RANK = {s: i for i, s in enumerate(STAGES)}


class TicketTrace(NamedTuple):
    """One completed ticket's lifecycle, for the load harness + reports.

    ``stages`` is the span chain described in the module docstring —
    ``()`` when the owning server was built with ``trace=False``. The
    first five fields predate the telemetry layer and keep their exact
    meaning (`load_gen.summarize_trace` consumes only those).
    """

    ticket: int
    tenant: int
    submit_s: float  # time.perf_counter() at admission
    done_s: float  # time.perf_counter() at resolution (== submit_s if shed)
    status: str  # "ok" | "shed" | "error"
    stages: tuple = ()  # ((stage, perf_counter_s), ...), see STAGES

    @property
    def latency_s(self) -> float:
        return self.done_s - self.submit_s


def stage_durations(stages) -> dict:
    """Per-stage wall time of one span chain: {later_stage: seconds}.

    Stage ``s`` is charged the gap since the previous boundary, so the
    values sum to last-minus-first exactly (the chain is contiguous).
    """
    out = {}
    for (_, t0), (name, t1) in zip(stages, stages[1:]):
        out[name] = out.get(name, 0.0) + (t1 - t0)
    return out


def well_ordered(stages) -> bool:
    """True when `stages` is a valid span chain: names form a non-empty
    subsequence of `STAGES` starting at ``submit`` and ending at
    ``resolve``, with non-decreasing timestamps."""
    if not stages:
        return False
    names = [s for s, _ in stages]
    times = [t for _, t in stages]
    if names[0] != "submit" or names[-1] != "resolve":
        return False
    ranks = [_STAGE_RANK.get(n, -1) for n in names]
    if -1 in ranks or any(b <= a for a, b in zip(ranks, ranks[1:])):
        return False
    return all(b >= a for a, b in zip(times, times[1:]))


def trace_record(rec: TicketTrace) -> dict:
    """One `TicketTrace` as the JSON shape `tools/obs_report.py` reads."""
    return {"ticket": int(rec.ticket), "tenant": int(rec.tenant),
            "submit_s": float(rec.submit_s), "done_s": float(rec.done_s),
            "status": rec.status,
            "stages": [[s, float(t)] for s, t in rec.stages]}


def dump_trace(trace, path) -> int:
    """Write a `take_trace()` result as JSONL; returns the record count.

    The file is the input format of ``python tools/obs_report.py`` (one
    JSON object per line, `trace_record` shape).
    """
    n = 0
    with open(path, "w") as f:
        for rec in trace:
            f.write(json.dumps(trace_record(rec), sort_keys=True) + "\n")
            n += 1
    return n


# what `span` hands back while no profiler records: one context, reused
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context naming the work inside it `name` in a profiler's trace.

    While `torch.profiler` records, a `record_function(name)` range, on the
    same host clock as the trace's device events, which the profiler links
    to it by their launches; otherwise the shared no-op context, at the
    cost of one check (a `record_function` with no profiler recording
    would cost a call into the dispatcher's callbacks every time).
    """
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)
