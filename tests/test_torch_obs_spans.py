"""The port's spans inside the serve step (`repro_torch.obs.span`), on the
CPU with tiny engines, and once on the card.

Checked:
- under `torch.profiler`, one `serve` call records `serve` around
  `serve.lookup`, `serve.scan` and `serve.rank`, in that order and not
  overlapping;
- the dense plan records `nns.dense` around `nns.dense.select`; the
  streaming plan with a summary `nns.stream` around `nns.stream.bounds`,
  without one no bounds;
- the pipelined front-end's steps and the sync front-end, which call the
  stages one by one, record the three stage spans;
- with no profiler recording, `span` hands back one shared no-op context
  and never enters `record_function`;
- results are bit-equal with the profiler on and off;
- the modeled cost is computed once a candidate count;
- on the card (marker `cuda`, skipped without one), the device time
  launched inside the three stage spans is at least 98% of that launched
  inside `serve`, each device operation put down to the spans around the
  call on CUDA's API that launched it; and the sync front-end's `rank_s`
  stamp reads at least half of a rank stage that takes a millisecond or
  more on the device.

The file imports neither JAX nor the reference package.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import cost_model as cm
from repro_torch.core.lsh import make_lsh_projections
from repro_torch.models.recsys import (
    default_youtubednn_config,
    init_youtubednn,
)
from repro_torch.obs import tracing
from repro_torch.serving import make_server
from repro_torch.serving import recsys_engine as trs
from repro_torch.serving.hot_cache import CacheStats

STAGES = ("serve.lookup", "serve.scan", "serve.rank")
SPANS = frozenset(STAGES) | {"serve", "nns.dense", "nns.dense.select",
                             "nns.stream", "nns.stream.bounds"}
B = 24


def _engine(n_items, device="cpu", **knobs):
    cfg = default_youtubednn_config()._replace(n_items=n_items)
    gen = torch.Generator().manual_seed(n_items)
    params = init_youtubednn(gen, cfg, device="cpu")
    proj = make_lsh_projections(cfg.embed_dim, generator=gen)
    return trs.RecSysEngine.build(
        params, cfg, lsh_proj=proj, hot_rows=16,
        item_freqs=np.arange(n_items, 0, -1), device=device, **knobs)


def _batch(engine, n=B, seed=0):
    rng = np.random.default_rng(seed)
    cfg = engine.cfg
    raw = {k: rng.integers(0, c, n).astype(np.int32)
           for k, c in cfg.user_features.items()}
    raw["history"] = rng.integers(-1, cfg.n_items, (n, cfg.history_len)
                                  ).astype(np.int32)
    raw["genre"] = rng.integers(0, 18, n).astype(np.int32)
    return raw


def _queries(engine, n):
    raw = _batch(engine, n)
    return [{k: v[i] for k, v in raw.items()} for i in range(n)]


# a dense engine, a streaming one with its block summary, one without
PLANS = {"dense": dict(n_items=600, scan_block=0),
         "stream": dict(n_items=1024, scan_block=128),
         "stream_unpruned": dict(n_items=1024, scan_block=128, prune=False)}


@pytest.fixture(scope="module")
def engines():
    return {name: _engine(**kw) for name, kw in PLANS.items()}


def _spans(prof) -> list:
    """(name, start us, end us) of the program's spans, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name in SPANS
                   and e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_serve_records_its_three_stages_in_order(engines, plan):
    eng = engines[plan]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.serve(_batch(eng))
    spans = _spans(prof)
    roots = [s for s in spans if s[0] == "serve"]
    stages = [s for s in spans if s[0] in STAGES]
    assert len(roots) == 1
    assert [s[0] for s in stages] == list(STAGES)
    assert all(_inside(s, roots[0]) for s in stages)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))


@pytest.mark.parametrize("plan,want", [
    ("dense", [("nns.dense", "nns.dense.select")]),
    ("stream", [("nns.stream", "nns.stream.bounds")]),
    ("stream_unpruned", [("nns.stream", None)])])
def test_the_plan_that_ran_records_its_spans(engines, plan, want):
    eng = engines[plan]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.serve(_batch(eng))
    spans = _spans(prof)
    nns = [s for s in spans if s[0].startswith("nns.")]
    outer, inner = want[0]
    assert [s[0] for s in nns] == [outer] + ([inner] if inner else [])
    scan = next(s for s in spans if s[0] == "serve.scan")
    assert _inside(nns[0], scan)
    if inner:
        assert _inside(nns[1], nns[0])


@pytest.mark.parametrize("mode", ["sync", "pipelined"])
def test_front_ends_record_the_stage_spans(engines, mode):
    """Both front-ends call the three stages one by one (not `serve`):
    two full buckets and a padded tail, three spans each."""
    eng = engines["dense"]
    server = make_server(eng, mode, max_batch=8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        served = server.serve_many(_queries(eng, 20))
    server.close()
    assert len(served) == 20 and all(s.ok for s in served)
    names = [s[0] for s in _spans(prof)]
    assert "serve" not in names
    stages = [n for n in names if n in STAGES]
    assert stages == list(STAGES) * 3


def test_span_without_a_profiler_is_one_shared_no_op(engines, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    first, second = obs.span("serve"), tracing.span("nns.dense")
    assert first is second is tracing._NO_SPAN
    with first:
        pass
    for eng in engines.values():
        items = eng.serve(_batch(eng)).items
        assert items.shape == (B, eng.top_k)


def test_span_under_a_profiler_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx = obs.span("serve.scan")
        assert ctx is not tracing._NO_SPAN
        with ctx:
            torch.ones(3).sum()
    assert [e.name for e in prof.events()
            if e.name == "serve.scan"] == ["serve.scan"]


def _leaves(result):
    out = []
    for x in result:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, tuple):
            out.extend(_leaves(x))
    return out


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_results_bit_equal_with_the_profiler_on_and_off(engines, plan):
    eng = engines[plan]
    batch = _batch(eng, seed=3)
    off = eng.serve(batch)
    with profile(activities=[ProfilerActivity.CPU]):
        on = eng.serve(batch)
    assert off.cost == on.cost
    a, b = _leaves(off), _leaves(on)
    assert len(a) == len(b) > 5
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_modeled_cost_is_computed_once_a_candidate_count(engines,
                                                         monkeypatch):
    calls = []
    model = cm.end_to_end_movielens

    def counted(**kw):
        calls.append(kw)
        return model(**kw)

    monkeypatch.setattr(cm, "end_to_end_movielens", counted)
    eng = dataclasses.replace(engines["dense"], n_candidates=37)
    trs._modeled_cost.cache_clear()
    costs = [eng.serve(_batch(eng)).cost, eng.serve(_batch(eng)).cost,
             eng.query_cost()]
    assert calls == [{"n_candidates": 37}]
    e2e = model(n_candidates=37)
    want = cm.OpCost(latency_ns=e2e["imars_latency_us"] * 1e3,
                     energy_pj=e2e["imars_energy_uj"] * 1e6)
    assert all(c == want for c in costs)
    trs._modeled_cost.cache_clear()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda", 0)


# calls on CUDA's API (cudaLaunchKernel, cudaMemcpyAsync, ...); a device
# operation has the correlation id of the call that queued it
CUDA_CALL = re.compile(r"cu(da)?[A-Z]")


def _device_s_by_span(prof) -> dict:
    """Device seconds of the operations launched inside each span (the
    call that launched one lies in the span on the host's clock), and
    under "all" of every operation."""
    cpu = torch.autograd.DeviceType.CPU
    events = prof.events()
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in events if e.device_type == cpu and e.name in SPANS]
    calls = {e.id: e.time_range.start for e in events
             if e.device_type == cpu and CUDA_CALL.match(e.name)}
    out = {"all": 0.0}
    for e in events:
        if e.device_type == cpu or e.name in SPANS:
            continue
        s = e.time_range.elapsed_us() / 1e6
        out["all"] += s
        at = calls.get(e.id)
        for name in {n for n, a, z in spans
                     if at is not None and a <= at <= z}:
            out[name] = out.get(name, 0.0) + s
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n_items,scan_block", [(3000, None),
                                                (1 << 18, None)])
def test_stage_spans_hold_the_serve_device_time(cuda, n_items, scan_block):
    """The dense plan (3,000 rows) and the pruned streaming plan (2^18
    rows), 2,048 queries a batch: the device time launched inside the
    three stage spans is at least 98% of that launched inside `serve`."""
    eng = _engine(n_items, device=cuda, scan_block=scan_block)
    batches = [eng.batch_to_device(_batch(eng, 2048, seed=s))
               for s in range(4)]
    eng.serve(batches[0])
    torch.cuda.synchronize(cuda)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches:
            eng.serve(b)
        torch.cuda.synchronize(cuda)
    assert [s[0] for s in _spans(prof)].count("serve") == len(batches)
    times = _device_s_by_span(prof)
    root = times.get("serve", 0.0)
    stages = sum(times.get(s, 0.0) for s in STAGES)
    assert root >= 0.98 * times["all"] > 0, times
    assert stages >= 0.98 * root, times
    plan = "nns.stream.bounds" if n_items >= 1 << 18 else "nns.dense.select"
    assert times.get(plan, 0.0) > 0, times


def _device_ms(fn, repeats=4):
    """The least device ms of `fn()` over `repeats` calls after the first,
    by CUDA events; and its last result."""
    times = []
    for _ in range(repeats + 1):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        out = fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return min(times[1:]), out


@pytest.mark.cuda
def test_sync_stage_stamps_split_at_the_scan(cuda):
    """A bucket on the dense plan whose rank stage takes a millisecond or
    more on the device (16,384 queries, or more until it does): the sync
    front-end's `rank_s` stamp reads at least half of the rank stage, and
    its `scan_s` stamp less than the lookup and scan stages and half the
    rank stage. (Before, `scan_s` waited for a copy queued after the rank
    stage, so it held all three; `rank_s` held only the host's cost of the
    items' copy, which on the card may itself take a millisecond.)"""
    eng = _engine(3000, device=cuda)
    stats = CacheStats.zero(cuda)
    for n in (16384, 32768, 65536):
        batch = eng.batch_to_device(_batch(eng, n))
        lookup_ms, (u, pooled, _) = _device_ms(
            lambda: trs.lookup_step(eng, batch, stats))
        scan_ms, nns = _device_ms(lambda: trs.scan_step(eng, u))
        rank_ms, _ = _device_ms(lambda: trs.rank_stage_step(
            eng, batch, nns.indices, u, pooled, stats))
        if rank_ms >= 1.0:
            break
    else:
        pytest.skip(f"the rank stage of {n} queries takes {rank_ms:.3f} "
                    "device ms, under the millisecond the stamps need")
    queries = _queries(eng, n)
    served = []
    for warm in (True, False):  # a server's first bucket pins its buffers
        server = make_server(eng, "sync", max_batch=n)
        for _ in range(1 if warm else 4):
            served.extend(server.serve_many(queries))
        snap = server.snapshot()
        server.close()
    assert all(s.ok for s in served)
    stamped = {k: snap[f"serving.stage.{k}_s.mean"] * 1e3
               for k in ("dispatch", "scan", "rank")}
    lookup_scan_ms = lookup_ms + scan_ms
    print(f"device ms: lookup + scan {lookup_scan_ms:.3f}, rank "
          f"{rank_ms:.3f}; stamped ms (mean of 4): " + ", ".join(
              f"{k} {v:.3f}" for k, v in stamped.items()))
    assert stamped["rank"] >= 0.5 * rank_ms
    assert stamped["scan"] < lookup_scan_ms + 0.5 * rank_ms
