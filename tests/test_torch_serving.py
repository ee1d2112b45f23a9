"""The port's serving front-ends, cost model and `hit_rate`, on the CPU.

A `repro` engine is built from `init_youtubednn` parameters with the
default MovieLens config cut to 600 items, and loaded into a `repro_torch`
engine (`convert.engine_from_arrays`, as `tests/test_torch_engine.py`
does). Queries come from the synthetic MovieLens set (`make_movielens`,
the port's copy held equal to the reference's here), served through
`make_server` with `max_batch` 16.

Checked:
- every mode against the port's sync mode bit for bit: items, scores and
  cache counters (pipelined at depth 1, 2 and 3, coalesced, concurrent
  with its queue staged before the drain starts, so that its buckets are
  sync's). Where a drain thread races the submitters, a query may land in
  a bucket of another size, and PyTorch's matmul may then round its CTRs
  differently in the last bit (a one-row product on the CPU): there the
  CTRs are held within 1e-6 and the ids wherever the gaps decide them;
- the port's sync mode against the reference's, by
  `tests/test_torch_engine.py`'s rule: cache counters equal, CTRs within
  1e-6, ids equal wherever the CTR gaps that decide them exceed that
  tolerance (rows whose query signatures agree, as there);
- the staged steps compose to `serve_step`; the `Server` protocol's
  behaviour, as `tests/test_server_protocol.py` checks the reference's;
- `LoadGen` schedules, `summarize_trace`, the cost model and mapping, the
  metrics registry: equal to the reference's (floats with ``==``);
- `hit_rate` in its three modes: per user, the retrieved top-k set equals
  the reference's, and the hit counts agree, except for users whose k-th
  and (k+1)-th similarities lie within 1e-6 (fp32, int8) or whose LSH
  projection has an entry within float noise of 0 (lsh): float32 noise may
  order those either way, so they are excused and counted.
Every wait on a drain thread has a timeout.
"""
import dataclasses
import threading
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import cost_model as jcm
from repro.core import mapping as jmp
from repro.core.lsh import lsh_signature as jlsh_signature
from repro.data import synthetic as jsyn
from repro.models import recsys as jrs
from repro.serving import LoadGen as JLoadGen
from repro.serving import RecSysEngine as JaxEngine
from repro.serving import make_server as jmake_server
from repro.serving import summarize_trace as jsummarize_trace
from repro.serving.recsys_engine import _features as jax_features
from repro.serving.recsys_engine import _hr_step as j_hr_step
from repro.serving.recsys_engine import hit_rate as jhit_rate
from repro_torch import obs
from repro_torch.convert import engine_from_arrays
from repro_torch.core import cost_model as cm
from repro_torch.core import mapping as mp
from repro_torch.core.lsh import lsh_signature
from repro_torch.data import synthetic
from repro_torch.serving import (
    STATUS_ERROR,
    STATUS_OK,
    STATUS_SHED,
    ConcurrentFrontend,
    LoadGen,
    QueueFullError,
    SchemaMismatchError,
    Server,
    ServerClosedError,
    ServerConfigError,
    ServingError,
    make_server,
    summarize_trace,
)
from repro_torch.serving import recsys_engine as trs
from repro_torch.serving.hot_cache import CacheStats
from test_torch_engine import _decided_prefix, export

N_ITEMS = 600
N_USERS = 200
MAX_BATCH = 16
FLOAT_RTOL = 1e-6
TIE_TOL = 1e-6
WAIT_S = 30.0
MODES = ("sync", "pipelined", "concurrent")


@pytest.fixture(scope="module")
def served():
    data = jsyn.make_movielens(n_users=N_USERS, n_items=N_ITEMS)
    cfg = jrs.default_youtubednn_config()._replace(n_items=N_ITEMS)
    params = jrs.init_youtubednn(jax.random.key(0), cfg)
    freqs = np.bincount(data.histories[data.histories >= 0],
                        minlength=N_ITEMS)
    jeng = JaxEngine.build(params, cfg, hot_rows=64, item_freqs=freqs)
    teng = engine_from_arrays(**export(jeng), device="cpu")
    return jeng, teng, data


def _make(engine, mode, **knobs):
    knobs.setdefault("max_batch", MAX_BATCH)
    if mode == "concurrent":
        knobs.setdefault("tenants", 4)
    return make_server(engine, mode, **knobs)


def _stream(data, n=45):
    """n queries (full buckets and a padded tail), users repeating."""
    return synthetic.serving_queries(data, np.arange(n) % 37)


def _flush(server):
    """`server.flush()`, bounded: a hung drain fails the test."""
    th = threading.Thread(target=server.flush, daemon=True)
    th.start()
    th.join(WAIT_S)
    assert not th.is_alive(), "flush did not return"


def _serve_many(server, queries, tenant=0):
    """`server.serve_many`, its flush bounded by `_flush`."""
    tickets = [server.submit(q, tenant=tenant) for q in queries]
    _flush(server)
    return [server.result(t, timeout=WAIT_S) for t in tickets]


def _assert_served_like(got, want):
    """A ticket served in a bucket of possibly another size: CTRs within
    1e-6, ids equal wherever the CTR gaps that decide them exceed 2e-6."""
    assert got.status == STATUS_OK
    np.testing.assert_allclose(got.scores, want.scores, rtol=FLOAT_RTOL,
                               atol=1e-7)
    k = int(_decided_prefix(want.scores[None], 2e-6)[0])
    np.testing.assert_array_equal(got.items[:k], want.items[:k])


def _counters(stats):
    return {k: stats[k] for k in ("n_served", "n_padded", "n_batches",
                                  "cache_hits", "cache_lookups")}


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_factory_builds_protocol_instances(served, mode):
    _, teng, _ = served
    server = _make(teng, mode)
    assert isinstance(server, Server)
    assert server.mode == mode
    st = server.stats()
    assert st["mode"] == mode and st["n_submitted"] == 0
    server.close()
    assert server.stats()["closed"]


def test_factory_rejects_unknown_mode_and_knobs(served):
    _, teng, _ = served
    with pytest.raises(ServerConfigError, match="unknown serving mode"):
        make_server(teng, "warp")
    with pytest.raises(ServerConfigError, match="sync"):
        make_server(teng, "sync", depth=2)
    with pytest.raises(ServerConfigError, match="tenants"):
        make_server(teng, "pipelined", tenants=4)
    with pytest.raises(ServerConfigError):
        make_server(teng, "concurrent", bogus_knob=1)
    with pytest.raises(ServerConfigError, match="depth"):
        make_server(teng, "pipelined", depth=0)
    with pytest.raises(ServerConfigError, match="coalesce"):
        make_server(teng, "pipelined", coalesce=0)
    with pytest.raises(ServerConfigError, match="max_batch"):
        make_server(teng, "sync", max_batch=16, buckets=(4, 8))


# ---------------------------------------------------------------------------
# parity: every mode against sync in the port, sync against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,knobs", [
    ("pipelined", {"depth": 1}), ("pipelined", {"depth": 2}),
    ("pipelined", {"depth": 3}), ("pipelined", {"depth": 2, "coalesce": 2}),
    ("concurrent", {"depth": 2, "autostart": False})])
def test_modes_bitmatch_sync(served, mode, knobs):
    _, teng, data = served
    stream = _stream(data)
    ref = _make(teng, "sync")
    want = ref.serve_many(stream)
    server = _make(teng, mode, **knobs)
    got = _serve_many(server, stream)
    for w, g in zip(want, got):
        assert g.status == STATUS_OK and g.ok
        assert g.items.dtype == np.int32 and g.scores.dtype == np.float32
        np.testing.assert_array_equal(w.items, g.items)
        np.testing.assert_array_equal(w.scores, g.scores)
    assert _counters(server.stats()) == _counters(ref.stats())
    assert server.stats()["cache_hits"] > 0
    assert server.stats()["in_flight"] == 0
    server.close()
    ref.close()


def test_sync_matches_reference_sync(served):
    jeng, teng, data = served
    stream = _stream(data)
    ref = jmake_server(jeng, "sync", max_batch=MAX_BATCH)
    want = ref.serve_many(stream)
    server = _make(teng, "sync")
    got = server.serve_many(stream)
    for key in ("n_served", "n_padded", "n_batches", "cache_hits",
                "cache_lookups"):
        assert server.stats()[key] == ref.stats()[key], key

    # which queries the two packages sign alike (bits with |u @ proj| ~ 0
    # may flip; those queries' candidates may differ)
    batch = {k: np.stack([np.asarray(q[k]) for q in stream]).astype(np.int32)
             for k in stream[0]}
    u_want = jax.jit(jax_features)(
        jeng, {k: jnp.asarray(v) for k, v in batch.items()})[0]
    q_want = np.asarray(jlsh_signature(u_want, jeng.lsh_proj)).view(np.int32)
    q_got = lsh_signature(teng.user_embedding(batch), teng.lsh_proj).numpy()
    same = (q_want == q_got).all(1)
    assert same.mean() > 0.9, same.mean()

    scores_want = np.stack([w.scores for w in want])
    n_decided = _decided_prefix(scores_want, 2e-6)
    checked = 0
    for r, (w, g) in enumerate(zip(want, got)):
        if not same[r]:
            continue
        np.testing.assert_allclose(g.scores, w.scores, rtol=FLOAT_RTOL,
                                   atol=1e-7)
        k = int(n_decided[r])
        np.testing.assert_array_equal(g.items[:k], w.items[:k])
        checked += k
    assert checked > len(stream) * 2  # real candidates were ranked
    server.close()
    ref.close()


@pytest.mark.parametrize("scan_block", [None, 128])
def test_staged_steps_compose_to_serve_step(served, scan_block):
    _, teng, data = served
    eng = dataclasses.replace(teng, scan_block=scan_block)
    server = _make(eng, "sync")
    batch = server._stack(_stream(data, 13), MAX_BATCH)
    items, top, nns, stats = trs.serve_step(eng, batch, CacheStats.zero())
    u, pooled, st = trs.lookup_step(eng, batch, CacheStats.zero())
    nns2 = trs.scan_step(eng, u)
    items2, top2, st = trs.rank_stage_step(eng, batch, nns2.indices, u,
                                           pooled, st)
    assert torch.equal(items, items2)
    assert torch.equal(top.scores, top2.scores)
    assert torch.equal(top.indices, top2.indices)
    for f in ("indices", "distances", "counts"):
        assert torch.equal(getattr(nns, f), getattr(nns2, f))
    assert (nns.blocks_touched is None) == (scan_block is None)
    assert st.as_dict() == stats.as_dict()
    assert trs.n_summary_blocks(eng) == eng.block_summary.n_blocks


# ---------------------------------------------------------------------------
# the protocol's behaviour (tests/test_server_protocol.py for the reference)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_ticket_api_and_tenant_accounting(served, mode):
    _, teng, data = served
    server = _make(teng, mode)
    stream = _stream(data, 6)
    tickets = [server.submit(q, tenant=i % 2) for i, q in enumerate(stream)]
    _flush(server)
    ref = _make(teng, "sync").serve_many(stream)
    for i, (t, w) in enumerate(zip(tickets, ref)):
        got = server.result(t, timeout=WAIT_S)
        _assert_served_like(got, w)
        assert got.tenant == i % 2
        assert obs.well_ordered(got.stages)
    pt = server.stats()["per_tenant"]
    assert pt[0]["served"] == 3 and pt[1]["served"] == 3
    with pytest.raises(KeyError):
        server.result(tickets[0])
    server.close()


@pytest.mark.parametrize("mode", MODES)
def test_closed_server_rejects_submits(served, mode):
    _, teng, data = served
    server = _make(teng, mode)
    server.close()
    with pytest.raises(ServerClosedError):
        server.submit(_stream(data, 1)[0])
    server.close()  # idempotent


@pytest.mark.parametrize("mode", MODES)
def test_swap_engine_schema_mismatch_is_typed(served, mode):
    _, teng, data = served
    other = dataclasses.replace(
        teng, cfg=teng.cfg._replace(user_features={"user_id": 6040}))
    server = _make(teng, mode)
    with pytest.raises(SchemaMismatchError, match="schema"):
        server.swap_engine(other)
    server.swap_engine(dataclasses.replace(teng))  # same schema: swaps
    out = _serve_many(server, _stream(data, 3))
    assert all(s.ok for s in out)
    server.close()


def test_full_queue_sheds_with_accounting(served):
    _, teng, data = served
    server = _make(teng, "concurrent", queue_depth=4, autostart=False)
    stream = _stream(data, 19)
    tickets = [server.submit(q) for q in stream]
    assert server.stats()["per_tenant"][0]["shed"] == len(stream) - 4
    server.start()
    _flush(server)
    ref = _make(teng, "sync").serve_many(stream[:4])
    got = [server.result(t, timeout=WAIT_S) for t in tickets]
    for g, w in zip(got[:4], ref):
        assert g.status == STATUS_OK
        np.testing.assert_array_equal(g.items, w.items)
    for g in got[4:]:
        assert g.status == STATUS_SHED and not g.ok
        assert (g.items == -1).all() and (g.scores == 0).all()
    pt = server.stats()["per_tenant"][0]
    assert pt["submitted"] == len(stream)
    assert pt["served"] + pt["shed"] + pt["errors"] == len(stream)
    trace = server.take_trace()
    assert sum(r.status == STATUS_SHED for r in trace) == len(stream) - 4
    server.close()


def test_shed_false_raises_queue_full(served):
    _, teng, data = served
    server = _make(teng, "concurrent", queue_depth=2, shed=False,
                   autostart=False)
    q = _stream(data, 1)[0]
    server.submit(q)
    server.submit(q)
    with pytest.raises(QueueFullError):
        server.submit(q)
    assert server.stats()["per_tenant"][0]["submitted"] == 2
    server.start()
    server.close()


@pytest.mark.parametrize("autostart", [True, False])
def test_close_with_inflight_tickets_drains(served, autostart):
    _, teng, data = served
    stream = _stream(data, 9)
    server = _make(teng, "concurrent", autostart=autostart)
    tickets = [server.submit(q, tenant=i % 3) for i, q in enumerate(stream)]
    server.close()
    assert not server._thread.is_alive()
    got = [server.result(t, timeout=WAIT_S) for t in tickets]
    ref = _make(teng, "sync").serve_many(stream)
    for g, w in zip(got, ref):
        _assert_served_like(g, w)


def test_drain_thread_survives_engine_errors(served):
    _, teng, data = served
    server = _make(teng, "concurrent", autostart=False)
    stream = _stream(data, 4)
    boom = ServingError("injected serve failure")
    real_inner = server._inner

    class _Exploding:
        engine = real_inner.engine
        _pending: list = []
        _ring = deque()
        _results: dict = {}

        def submit(self, q):
            raise boom

    server._inner = _Exploding()
    bad = [server.submit(q) for q in stream]
    server.start()
    _flush(server)
    got = [server.result(t, timeout=WAIT_S) for t in bad]
    assert all(g.status == STATUS_ERROR for g in got)
    server._inner = real_inner
    st = server.stats()
    assert st["last_error"] == "ServingError: injected serve failure"
    assert st["per_tenant"][0]["errors"] == len(stream)
    assert st["n_errors"] == len(stream)
    ok = [server.submit(q) for q in stream]
    _flush(server)
    ref = _make(teng, "sync").serve_many(stream)
    for t, w in zip(ok, ref):
        _assert_served_like(server.result(t, timeout=WAIT_S), w)
    server.close()


def test_concurrent_submitters_one_drain(served):
    _, teng, data = served
    server = _make(teng, "concurrent", tenants=4, queue_depth=64)
    stream = _stream(data, 8)
    ref = _make(teng, "sync").serve_many(stream)
    results = {}

    def worker(tenant):
        ts = [server.submit(q, tenant=tenant) for q in stream]
        _flush(server)
        results[tenant] = [server.result(t, timeout=WAIT_S) for t in ts]

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive(), "submitter deadlocked"
    assert sorted(results) == [0, 1, 2, 3]
    for tenant, got in results.items():
        assert [g.tenant for g in got] == [tenant] * len(stream)
        for g, w in zip(got, ref):
            _assert_served_like(g, w)
    server.close()


# ---------------------------------------------------------------------------
# load generation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(rate_qps=200, duration_s=0.5, tenants=2, pool_size=32, zipf_a=1.2,
         seed=7),
    dict(rate_qps=500, duration_s=2.0, pool_size=8, seed=1,
         burst=(0.5, 0.25, 4.0)),
    dict(rate_qps=2000, duration_s=1.0, tenants=3, pool_size=2048,
         zipf_a=1.1, seed=0)])
def test_load_gen_schedule_equals_reference(kw):
    got = LoadGen(**kw).schedule()
    assert got == JLoadGen(**kw).schedule() and len(got) > 0


def test_summarize_trace_equals_reference():
    rng = np.random.default_rng(5)
    status = rng.choice([STATUS_OK, STATUS_SHED, STATUS_ERROR], 300,
                        p=[0.8, 0.15, 0.05])
    sub = np.cumsum(rng.exponential(1e-3, 300))
    done = sub + rng.exponential(2e-3, 300) * (status != STATUS_SHED)
    recs = [(i, int(rng.integers(0, 3)), float(s), float(d), str(st))
            for i, (s, d, st) in enumerate(zip(sub, done, status))]
    got = summarize_trace([obs.TicketTrace(*r) for r in recs], 0.4)
    want = jsummarize_trace([jobs.TicketTrace(*r) for r in recs], 0.4)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_load_gen_replay_and_summary(served):
    """Replay through the concurrent front-end: the trace accounts every
    arrival and every admitted ticket is served like the sync serve of its
    query (its bucket depends on the replay's timing)."""
    _, teng, data = served
    pool = synthetic.serving_queries(data, np.arange(16))
    gen = LoadGen(rate_qps=400, duration_s=0.3, tenants=2, pool_size=16,
                  seed=3)
    server = _make(teng, "concurrent", tenants=2, queue_depth=64)
    replay = gen.replay(server, pool)
    _flush(server)
    trace = server.take_trace()
    assert len(trace) == len(replay) == len(gen.schedule())
    summary = summarize_trace(trace, gen.duration_s)
    assert set(summary.per_tenant) == {0, 1}
    assert summary.error_frac == 0.0
    ref = _make(teng, "sync").serve_many(pool)
    for ticket, tenant, qi in replay:
        got = server.result(ticket, timeout=WAIT_S)
        assert got.tenant == tenant
        if got.status == STATUS_OK:
            _assert_served_like(got, ref[qi])
    server.close()


@pytest.mark.parametrize("mode", MODES)
def test_dumped_trace_renders_through_obs_report(served, mode, tmp_path):
    """A real front-end's trace, written by `obs.dump_trace`, loads and
    renders through `tools/obs_report.py`, as the reference's does
    (`tests/test_obs.py`): every ticket ok, the served stages present,
    the stage means summing to the mean latency."""
    from tools.obs_report import load_trace, render_breakdown, stage_breakdown

    _, teng, data = served
    stream = _stream(data)
    server = _make(teng, mode)
    _serve_many(server, stream)
    trace = server.take_trace()
    path = tmp_path / "trace.jsonl"
    assert obs.dump_trace(trace, path) == len(trace) == len(stream)
    bd = stage_breakdown(load_trace(path), status=STATUS_OK)
    assert bd["n"] == len(stream) and bd["by_status"] == {
        STATUS_OK: len(stream)}
    assert set(bd["stages"]) >= {"bucket", "dispatch", "scan", "rank"}
    assert bd["stage_sum_mean_s"] == pytest.approx(bd["latency_s"]["mean"])
    table = render_breakdown(bd)
    assert "stage-sum mean" in table and "scan" in table
    server.close()


def test_frontend_direct_construction(served):
    _, teng, data = served
    fe = ConcurrentFrontend(teng, tenants=2, max_batch=MAX_BATCH)
    out = _serve_many(fe, _stream(data, 3), tenant=1)
    assert all(s.ok and s.tenant == 1 for s in out)
    fe.close()


# ---------------------------------------------------------------------------
# the paper's cost model, the mapping, the synthetic data
# ---------------------------------------------------------------------------
def _plain(x):
    """Dataclasses as dicts (recursively), for == against the reference."""
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


@pytest.mark.parametrize("name,args", [
    ("movielens_mapping", ()), ("criteo_mapping", ()),
    ("table3_model", ()), ("ml_nns_model", ()),
    ("end_to_end_movielens", ()), ("end_to_end_movielens", (10,)),
    ("end_to_end_movielens", (128,)), ("end_to_end_criteo", ()),
    ("design_space_lookup_cost", (28000, 1, 8)),
    ("design_space_lookup_cost", (28000, 1, 128)),
    ("design_space_lookup_cost", (256, 12, 32, 3)),
    ("movielens_et_costs", ()), ("criteo_et_costs", ())])
def test_cost_model_equals_reference(name, args):
    mod, jmod = (mp, jmp) if name.endswith("mapping") else (cm, jcm)
    got, want = getattr(mod, name)(*args), getattr(jmod, name)(*args)
    if isinstance(got, dict):
        got = {k: _plain(v) for k, v in got.items()}
        want = {k: _plain(v) for k, v in want.items()}
    assert _plain(got) == _plain(want)


def test_cost_model_constants_equal_reference():
    for name in ("ARRAY_FOM", "GPU_PAPER", "GPU_IMPLIED",
                 "PAPER_TABLE3_IMARS", "PAPER_END_TO_END", "ML_FILTER_DNN",
                 "ML_RANK_DNN", "N_CANDIDATES"):
        assert getattr(cm, name) == getattr(jcm, name), name
    assert _plain(cm.CAL) == _plain(jcm.CAL)
    assert [_plain(e) for e in mp.MOVIELENS_ETS] == \
        [_plain(e) for e in jmp.MOVIELENS_ETS]


def test_serve_result_cost_is_the_query_cost(served):
    jeng, teng, data = served
    batch = synthetic.serving_queries(data, np.arange(4))
    stacked = {k: np.stack([np.asarray(q[k]) for q in batch])
               for k in batch[0]}
    cost = teng.serve(stacked).cost
    assert cost == teng.query_cost()
    assert _plain(cost) == _plain(jeng.query_cost())
    e2e = cm.end_to_end_movielens(n_candidates=teng.n_candidates)
    assert cost.latency_us == e2e["imars_latency_us"]


def test_synthetic_data_equals_reference():
    got = synthetic.make_movielens(n_users=50, n_items=80, seed=3)
    want = jsyn.make_movielens(n_users=50, n_items=80, seed=3)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a, b)
    qa = synthetic.serving_queries(got, [0, 7])
    qb = jsyn.serving_queries(want, [0, 7])
    for a, b in zip(qa, qb):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# hit_rate in the paper's three accuracy configurations
# ---------------------------------------------------------------------------
def _hr_batch(data, idx):
    return {**{k: v[idx] for k, v in data.user_feats.items()},
            "history": data.histories[idx], "genre": data.genres[idx]}


def _excused(jeng, batch, mode, k):
    """(B,) True for users whose top-k float32 noise may decide."""
    jb = {n: jnp.asarray(v) for n, v in batch.items()}
    if mode == "lsh":
        u = np.asarray(jax_features(jeng, jb)[0], np.float64)
        proj = np.asarray(jeng.lsh_proj, np.float64)
        x = u @ proj
        scale = (np.linalg.norm(u, axis=1)[:, None]
                 * np.linalg.norm(proj, axis=0)[None])
        return (np.abs(x) <= TIE_TOL * scale).any(1)
    if mode == "fp32":
        u = jrs.user_tower(jeng.params, jeng.cfg, jb)
        db = jeng.params["item_table"]
    else:
        from repro.core.quantization import dequantize_rowwise
        u = jax_features(jeng, jb)[0]
        db = dequantize_rowwise(jeng.item_table_q)
    u, db = np.asarray(u, np.float64), np.asarray(db, np.float64)
    sims = (u / np.linalg.norm(u, axis=1, keepdims=True)) @ (
        db / np.linalg.norm(db, axis=1, keepdims=True)).T
    s = -np.sort(-sims, axis=1)
    return s[:, k - 1] - s[:, k] <= TIE_TOL


@pytest.mark.parametrize("mode", ["fp32", "int8", "lsh"])
def test_hit_rate_equals_reference(served, mode):
    jeng, teng, _ = served
    data = synthetic.make_movielens(n_users=N_USERS, n_items=N_ITEMS)
    k, bs = 10, 64  # 200 users: the last chunk is padded
    idx = np.arange(N_USERS)
    batch = _hr_batch(data, idx)
    got = trs._hr_step(teng, teng.batch_to_device(batch), mode, k).numpy()
    want = np.asarray(j_hr_step(
        jeng, {n: jnp.asarray(v) for n, v in batch.items()}, mode, k))
    excused = _excused(jeng, batch, mode, k)
    assert excused.sum() <= N_USERS // 20, excused.sum()
    ok = ~excused
    np.testing.assert_array_equal(np.sort(got[ok], 1), np.sort(want[ok], 1))
    if mode == "lsh":  # the candidates' order is exact too
        np.testing.assert_array_equal(got[ok], want[ok])
    labels = data.test_labels[idx]
    hits_got = (got == labels[:, None]).any(1)
    hits_want = (want == labels[:, None]).any(1)
    np.testing.assert_array_equal(hits_got[ok], hits_want[ok])

    n_got = round(trs.hit_rate(teng, data, batch_size=bs, k=k, mode=mode)
                  * N_USERS)
    n_want = round(jhit_rate(jeng, data, batch_size=bs, k=k, mode=mode)
                   * N_USERS)
    assert n_got == int(hits_got.sum())
    assert abs(n_got - n_want) <= int(excused.sum())
    if not excused.any():
        assert n_got == n_want


def test_hit_rate_refuses_unknown_mode(served):
    _, teng, data = served
    with pytest.raises(ValueError, match="mode"):
        trs.hit_rate(teng, data, mode="cosine", max_users=4)


# ---------------------------------------------------------------------------
# observability: the registry's exports equal the reference's
# ---------------------------------------------------------------------------
def _drive(reg):
    for i in range(50):
        reg.count("serving.served", 3)
        reg.observe("serving.ticket_latency_s", 1e-4 * (i + 1) ** 1.5)
        reg.observe("serving.stage.scan_s", 2e-5 * (i % 7 + 1))
    reg.count("nns.blocks_touched", 123)
    reg.gauge("cache.hits", 17)
    reg.gauge("serving.ring_depth", 2)
    reg.info("serving.mode", "pipelined")
    reg.register_collector(lambda r: r.gauge("serving.pending", 4))


def test_metrics_registry_exports_equal_reference():
    got, want = obs.MetricsRegistry(), jobs.MetricsRegistry()
    _drive(got)
    _drive(want)
    assert got.snapshot() == want.snapshot()
    assert got.to_prometheus() == want.to_prometheus()
    assert obs.bucket_upper_bounds() == jobs.bucket_upper_bounds()
    chain = (("submit", 0.0), ("admit", 0.0), ("bucket", 0.5),
             ("dispatch", 0.6), ("scan", 1.5), ("rank", 1.5),
             ("resolve", 1.75))
    assert obs.stage_durations(chain) == jobs.stage_durations(chain)
    assert obs.well_ordered(chain) and jobs.well_ordered(chain)
    assert obs.STAGES == jobs.STAGES
