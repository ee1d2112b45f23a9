"""The concurrent front-end over a mesh engine of several ranks, and
snapshots of a bank-sharded live catalog, on the CPU over gloo.

The engine is `tests/test_torch_mesh_engine.py`'s: the reference's
768-item engine (radius 112, 16 candidates, top 5, 32 hot rows, a block
summary at 128 rows) exported to the port, on the dense and the pruned
plan, sharded over the banks alone, the queries alone and the query x
bank grid. Ranks are spawned with `tests/test_torch_mesh.py`'s `spawn`
on worlds 2 (the grid 2 x 1), 3 (1 x 3) and 4 (2 x 2); each asserts that
it never loaded `jax`. Every rank makes the same calls in the same
order; rank 0 alone submits (it is the front door) and holds its tickets
against the sync front-end, and the parent holds every rank's records
(`all/` keys: chunk logs, inner counters) equal to rank 0's. What each
rank holds:

- (a) a 37-query stream, staged before `start()` (`autostart=False`,
  unbounded queue), served bit-equal to the sync front-end on the same
  mesh engine and to the unsharded engine's concurrent front-end, on both
  plans and every mesh; every rank's inner counters equal sync's; rank
  0's tickets within the rule of `tests/test_torch_serving.py` of the
  reference's sync front-end on the same stream (CTRs within 1e-6, ids
  equal where the CTR gaps decide), its counters equal;
- (b) a `LiveCatalog` attached to the front-end takes an update and an
  update that overflows its delta (a forced compaction, nested in the
  update's pause window) between two staged halves: each half bit-equal
  to the sync front-end on the epoch it was served on, and every rank's
  chunk log ((sequence, epoch, count) a chunk) equal to rank 0's — one
  collective order on every rank;
- (c) two tenants submit from two threads while a third applies churn
  (re-upserts of rows the catalog already holds, byte for byte, a
  compaction and a model refresh: every epoch serves the same bits):
  every rank applies the churn in the same order, the chunk logs agree,
  and the tickets follow the rule for buckets formed under load;
- (d) a malformed query (a short history) and one missing a field
  resolve as errors on rank 0 and are never sent: the chunk logs hold
  only the next, served chunk;
- (f) a snapshot of the bank-sharded catalog after churn (a delta shard
  and tombstones pending) restores onto the same mesh, onto the other
  mesh of the world (the banks onto the grid) and onto an unsharded
  template, each serving bit-equal to the catalog it was taken from; its
  leaves equal the unsharded catalog's after the same churn but for the
  block summary (`serving/catalog.py` says why), which must equal where
  its block rows are the unsharded one's; an unsharded snapshot restores
  onto a sharded template.

On two ranks of their own:

- (e) a group built with a short timeout (`SHORT_TIMEOUT_S`, after a
  file barrier so the rendezvous fits in it): an idle gap longer than the
  timeout, then serving resumes; then a follower fails inside a chunk
  (an injected error after the broadcast): rank 0's ticket resolves as an
  error naming rank 1, its `submit` raises, and the follower's `close()`
  raises naming itself. On another such group rank 0 fails inside a
  chunk: its tickets are errors naming it, and the follower fails at its
  next collective and its `close()` names rank 0 — errors during a chunk
  close the stream on every rank;
- (g) an `OnlineTrainer` steps, folds and refreshes inside the pause
  window between two halves of a stream; each half bit-equal to sync on
  its epoch, the second also to `rebuild_from_params`.

In this process (one gloo rank): the stream's validation of malformed
chunks, and a swap onto another mesh refused.
"""
import dataclasses
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.serving import (
    LiveCatalog,
    OnlineTrainer,
    ServerClosedError,
    ServerConfigError,
    ServingError,
    make_server,
)
from repro_torch.utils import make_mesh
from test_torch_mesh import (
    meshes,
    rank_main,
    spawn,
    world1,  # noqa: F401 (a fixture)
)
from test_torch_mesh_engine import (
    B,
    DELTA,
    FLOAT_RTOL,
    N_ITEMS,
    PLANS,
    SHARDINGS,
    _assert_same_serve,
    _batch,
    _churn,
    _decided_prefix,
    _queries,
    _same_tickets,
    churn_from_inputs,
    churn_inputs,
    engine_from_inputs,
    engine_inputs,
)

WORLDS = (2, 3, 4)
WAIT_S = 60.0
SHORT_TIMEOUT_S = 4.0  # the process group of case (e)
IDLE_S = 5.0  # longer than that timeout
COUNTERS = ("n_served", "n_padded", "n_batches", "cache_hits",
            "cache_lookups")


# ---------------------------------------------------------------------------
# helpers of a rank
# ---------------------------------------------------------------------------
def _leader() -> bool:
    import torch.distributed as dist

    return dist.get_rank() == 0


def _counters(server) -> np.ndarray:
    st = server.stats()
    return np.array([st[k] for k in COUNTERS])


def _log(server) -> np.ndarray:
    return np.array(list(server.chunk_log), np.int64).reshape(-1, 3)


def _at_once(server, queries) -> list:
    """Rank 0: queue `queries` in one go (the drain thread cannot collect
    between two of them, so they form sync's buckets), start the drain if
    it waits, and collect the tickets."""
    with server._cv:
        tickets = [server.submit(q) for q in queries]
    server.start()
    return [server.result(t, timeout=WAIT_S) for t in tickets]


def _sync(engine, queries) -> tuple:
    """The sync front-end on `engine` (every rank: it runs collectives)
    -> (tickets, counters)."""
    server = make_server(engine, "sync", max_batch=B)
    got = server.serve_many(queries)
    server.close()
    return got, _counters(server)


def _served_like(got, want, what: str) -> None:
    """A ticket of a bucket formed under load: CTRs within 1e-6, ids equal
    wherever the CTR gaps that decide them exceed 2e-6."""
    assert got.ok, what
    _like(got.items, got.scores, want.items, want.scores, what)


def _like(items, scores, want_items, want_scores, what: str) -> None:
    want_scores = np.asarray(want_scores)
    np.testing.assert_allclose(scores, want_scores, rtol=FLOAT_RTOL,
                               atol=1e-7, err_msg=what)
    k = int(_decided_prefix(want_scores[None], 2e-6)[0])
    np.testing.assert_array_equal(items[:k], np.asarray(want_items)[:k],
                                  err_msg=what)


def _stream(inputs) -> list:
    return _queries({k[len("stream/"):]: v for k, v in inputs.items()
                     if k.startswith("stream/")})


def _batch0(inputs) -> dict:
    return {k[len("batch0/"):]: v for k, v in inputs.items()
            if k.startswith("batch0/")}


# ---------------------------------------------------------------------------
# (a)-(d), (f): what every rank of a world runs
# ---------------------------------------------------------------------------
def _case_a(out, key, eng, local, stream) -> None:
    conc = make_server(eng, "concurrent", max_batch=B, queue_depth=None,
                       autostart=False)
    got = _at_once(conc, stream) if conc.leader else None
    conc.close()
    want, sync_counters = _sync(eng, stream)
    out[f"all/{key}/a/counters"] = _counters(conc)
    out[f"all/{key}/a/sync_counters"] = sync_counters
    out[f"all/{key}/a/chunks"] = _log(conc)
    np.testing.assert_array_equal(_counters(conc), sync_counters)
    if conc.leader:
        _same_tickets(got, want, f"{key} concurrent vs sync")
        unsharded = make_server(local, "concurrent", max_batch=B,
                                coalesce=conc._inner.coalesce,
                                queue_depth=None, autostart=False)
        _same_tickets(got, _at_once(unsharded, stream),
                      f"{key} vs the unsharded concurrent front-end")
        unsharded.close()
        out[f"lead/{key}/items"] = np.stack([g.items for g in got])
        out[f"lead/{key}/scores"] = np.stack([g.scores for g in got])


def _case_b(out, key, eng, stream) -> None:
    rng = np.random.default_rng(7)
    cat = LiveCatalog(eng, delta_capacity=DELTA)
    conc = make_server(cat.engine, "concurrent", max_batch=B,
                       queue_depth=None, autostart=False)
    cat.attach(conc)
    before = cat.engine
    first, second = stream[:21], stream[21:]
    got1 = _at_once(conc, first) if conc.leader else None
    cat.upsert(np.arange(N_ITEMS, N_ITEMS + 6),
               rng.normal(size=(6, 32)).astype(np.float32))
    # 14 more new ids overflow the 16-slot delta: a forced compaction
    cat.upsert(np.arange(N_ITEMS + 6, N_ITEMS + 20),
               rng.normal(size=(14, 32)).astype(np.float32))
    assert cat.n_compactions == 1 and cat.engine.nns_mesh is eng.nns_mesh
    after = cat.engine
    got2 = _at_once(conc, second) if conc.leader else None
    conc.close()
    log = _log(conc)
    out[f"all/{key}/b/chunks"] = log
    out[f"all/{key}/b/counters"] = _counters(conc)
    # the attach swap, then the update, the compaction and the update
    # the compaction made room for: epochs 1 and 4
    assert sorted(set(log[:, 1].tolist())) == [1, 4], log
    want1, _ = _sync(before, first)
    want2, _ = _sync(after, second)
    if conc.leader:
        _same_tickets(got1, want1, f"{key} first half, epoch 1")
        _same_tickets(got2, want2, f"{key} second half, epoch 4")


def _case_c(out, key, eng, base, stream) -> None:
    """Churn that changes no served bit, from a third thread under load."""
    ids = np.r_[np.arange(0, 24, 3), [200, 401, 767]]
    rows = base.params["item_table"][ids].numpy().astype(np.float32)
    cat = LiveCatalog(eng, delta_capacity=DELTA)
    # the rows' bytes as the catalog quantizes them: every later
    # re-upsert of them is byte-equal
    cat.upsert(ids, rows)
    cat.refresh_model(base.params)
    cat.compact()
    canonical = cat.engine
    churn = [("upsert", ids[:5]), ("upsert", ids[5:]), ("compact",),
             ("refresh",), ("upsert", ids), ("compact",)]

    def apply_churn():
        for step in churn:
            if step[0] == "upsert":
                cat.upsert(step[1], rows[np.searchsorted(ids, step[1])])
            elif step[0] == "compact":
                cat.compact()
            else:
                cat.refresh_model(base.params)
            time.sleep(0.01)

    conc = make_server(canonical, "concurrent", max_batch=B, tenants=2,
                       queue_depth=64)
    cat.attach(conc)
    results = {}
    if conc.leader:
        def worker(tenant):
            ts = [conc.submit(q, tenant=tenant) for q in stream]
            results[tenant] = [conc.result(t, timeout=WAIT_S) for t in ts]

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in (0, 1)]
        threads.append(threading.Thread(target=apply_churn))
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT_S)
            assert not th.is_alive(), f"{key}: a thread did not finish"
    else:
        apply_churn()
    conc.close()
    out[f"all/{key}/c/chunks"] = _log(conc)
    out[f"all/{key}/c/counters"] = _counters(conc)
    out[f"all/{key}/c/epoch"] = np.array([cat.epoch, conc.epoch])
    want, _ = _sync(canonical, stream)
    if conc.leader:
        assert sorted(results) == [0, 1]
        for tenant, got in results.items():
            assert [g.tenant for g in got] == [tenant] * len(stream)
            for i, (g, w) in enumerate(zip(got, want)):
                _served_like(g, w, f"{key} tenant {tenant}, query {i}")


def _case_d(out, key, eng, stream) -> None:
    conc = make_server(eng, "concurrent", max_batch=B, queue_depth=None)
    if conc.leader:
        short = {**stream[0], "history": stream[0]["history"][:-1]}
        missing = {k: v for k, v in stream[1].items() if k != "genre"}
        for bad, why in ((short, "history"), (missing, "genre")):
            res = conc.result(conc.submit(bad), timeout=WAIT_S)
            assert res.status == "error", why
            assert why in conc.stats()["last_error"], conc.stats()
        got = _at_once(conc, stream[:5])
    conc.close()
    log = _log(conc)
    out[f"all/{key}/d/chunks"] = log
    assert log.tolist() == [[0, 0, 5]], log  # the bad chunks never went
    want, _ = _sync(eng, stream[:5])
    if conc.leader:
        _same_tickets(got, want, f"{key} after a malformed chunk")


def _leaves_equal(a, b, what: str, summary: bool = True) -> None:
    """Two engines' checkpointed leaves equal (the block summary's only
    where `summary`)."""
    from repro_torch.checkpoint.checkpointer import _leaves

    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys(), what
    for path, x in la.items():
        if path[0] == "block_summary" and not summary:
            continue
        assert torch.equal(x, lb[path]), f"{what}: {'/'.join(path)}"


def _summary_rows(engine) -> int:
    from repro_torch.core.nns import SUMMARY_BLOCK_ROWS

    s = engine.block_summary
    return SUMMARY_BLOCK_ROWS if s is None else s.block_rows


def _case_f(out, ms, base, inputs, directory) -> None:
    """Snapshot / restore of the bank-sharded catalogs of `ms`' two meshes
    with a bank axis."""
    import torch.distributed as dist

    from repro_torch.checkpoint import checkpointer

    leader = _leader()
    batch = _batch0(inputs)
    steps = churn_from_inputs(inputs)[:6]
    local = dataclasses.replace(base, scan_block=PLANS["pruned"])
    whole = LiveCatalog(local, delta_capacity=DELTA)
    cats = {mname: LiveCatalog(local.shard(ms[mname], SHARDINGS[mname][0],
                                           query_axis=SHARDINGS[mname][1]),
                               delta_capacity=DELTA)
            for mname in ("banks", "grid")}
    taken = []
    for n_done, step in enumerate(steps, 1):
        for cat in (whole, *cats.values()):
            _apply(cat, step)
        # after 5 steps a delta and tombstones are pending over the first
        # base (whose banks hold whole summary blocks wherever the world
        # divides 768 rows into multiples of 128); the 6th overflows the
        # delta: a forced compaction grows the table, and a delta is
        # pending again
        if n_done < 5:
            continue
        for mname, cat in cats.items():
            snap = Path(directory) / f"snap_{mname}_{n_done}"
            cat.snapshot(snap)
            assert checkpointer.latest_step(snap) == cat.epoch == whole.epoch
            # the snapshot's leaves: the unsharded catalog's (the
            # summary's where the banks summarize at its block rows)
            rows = _summary_rows(cat.engine)
            _leaves_equal(checkpointer.restore(snap, cat.epoch,
                                               whole.engine),
                          whole.engine, f"{mname} snapshot {n_done}",
                          rows == _summary_rows(whole.engine))
            out[f"all/f/{mname}_{n_done}/summary_rows"] = np.array(rows)
            taken.append((f"{mname} {n_done}", mname, cat.engine,
                          cat.epoch, whole.engine, snap))
    for what, mname, engine, epoch, unsharded, snap in taken:
        want = engine.serve(batch)
        other = "grid" if mname == "banks" else "banks"
        for target in (mname, other):
            axis, qaxis = SHARDINGS[target]
            back = LiveCatalog(local.shard(ms[target], axis,
                                           query_axis=qaxis),
                               delta_capacity=DELTA)
            back.restore(snap)
            assert back.epoch == epoch
            assert back.engine.nns_mesh is ms[target]
            _assert_same_serve(back.engine.serve(batch), want,
                               f"{what} snapshot onto {target}",
                               "common" if target == mname else "none")
        flat = LiveCatalog(local, delta_capacity=DELTA)
        flat.restore(snap)
        _assert_same_serve(flat.engine.serve(batch), want,
                           f"{what} snapshot onto an unsharded template",
                           "none")
        _leaves_equal(flat.engine, unsharded, f"{what} restored")
        out[f"all/f/{what}/items"] = want.items.numpy()
    # an unsharded snapshot onto a sharded template
    snap = Path(directory) / "snap_whole"
    if leader:
        whole.snapshot(snap)
    dist.barrier()
    back = LiveCatalog(local.shard(ms["banks"], "banks"),
                       delta_capacity=DELTA)
    back.restore(snap)
    _assert_same_serve(back.engine.serve(batch), whole.engine.serve(batch),
                       "an unsharded snapshot onto the banks", "none")


def _apply(cat, step) -> None:
    if step[0] == "upsert":
        cat.upsert(step[1], step[2])
    elif step[0] == "delete":
        cat.delete(step[1])
    else:
        cat.compact()


def rank_stream(inputs: dict, world: int) -> dict:
    base = engine_from_inputs(inputs)
    stream = _stream(inputs)
    ms = meshes(world)
    out = {}
    for mname, mesh in ms.items():
        axis, qaxis = SHARDINGS[mname]
        for plan, scan in PLANS.items():
            local = dataclasses.replace(base, scan_block=scan)
            eng = local.shard(mesh, axis, query_axis=qaxis)
            key = f"{mname}/{plan}"
            _case_a(out, key, eng, local, stream)
            if plan == "pruned" and mname != "qp":
                _case_b(out, key, eng, stream)
                _case_c(out, key, eng, base, stream)
                _case_d(out, key, eng, stream)
    _case_f(out, ms, base, inputs, sys.argv[4])
    return out


# ---------------------------------------------------------------------------
# (e) and (g): two ranks of their own
# ---------------------------------------------------------------------------
def rank_idle(inputs: dict, world: int) -> dict:
    """An idle gap past the group's timeout, then a follower failing."""
    import torch.distributed as dist

    base = dataclasses.replace(engine_from_inputs(inputs),
                               scan_block=PLANS["pruned"])
    eng = base.shard(make_mesh((world,), ("banks",), device="cpu"), "banks")
    stream = _stream(inputs)
    want1, _ = _sync(eng, stream[:10])
    want2, _ = _sync(eng, stream[10:20])
    conc = make_server(eng, "concurrent", max_batch=B, queue_depth=None)
    got1 = _at_once(conc, stream[:10]) if conc.leader else None
    time.sleep(IDLE_S)  # every rank: no traffic for longer than the timeout
    got2 = _at_once(conc, stream[10:20]) if conc.leader else None
    with conc.paused():  # every rank: the chunks before it are served
        out = {"all/e/chunks": _log(conc)}
        if dist.get_rank() == 1:
            def injected(queries):
                raise RuntimeError("injected failure")
            conc._serve = injected
    if conc.leader:
        _same_tickets(got1, want1, "before the idle gap")
        _same_tickets(got2, want2, "after the idle gap")
        res = conc.result(conc.submit(stream[20]), timeout=WAIT_S)
        assert res.status == "error"
        err = conc.stats()["last_error"]
        assert "rank 1" in err and "injected" in err, err
        with pytest.raises(ServerClosedError, match="rank 1"):
            conc.submit(stream[21])
        conc.close()
    else:
        with pytest.raises(ServingError, match="rank 1: .*injected"):
            conc.close()
        conc.close()  # raises once
    return out


def rank_leader_fails(inputs: dict, world: int) -> dict:
    """Rank 0 failing inside a chunk, after its broadcast: the follower
    fails at its next collective and names rank 0."""
    base = dataclasses.replace(engine_from_inputs(inputs),
                               scan_block=PLANS["pruned"])
    eng = base.shard(make_mesh((world,), ("banks",), device="cpu"), "banks")
    stream = _stream(inputs)
    conc = make_server(eng, "concurrent", max_batch=B, queue_depth=None)
    if conc.leader:
        def injected(queries):
            raise RuntimeError("injected failure")
        conc._serve = injected
        got = _at_once(conc, stream[:3])
        assert {g.status for g in got} == {"error"}
        err = conc.stats()["last_error"]
        assert "rank 0: RuntimeError: injected" in err, err
        with pytest.raises(ServerClosedError, match="rank 0"):
            conc.submit(stream[3])
        conc.close()
    else:
        with pytest.raises(ServingError, match="rank 0: .*injected"):
            conc.close()
    # rank 0 logs the chunk it sent; the follower never finished it
    assert _log(conc).tolist() == ([[0, 0, 3]] if conc.leader else [])
    return {"all/fail/closed": np.array([conc._closed or not conc.leader])}


def rank_online(inputs: dict, world: int) -> dict:
    """An `OnlineTrainer` folding through the pause window mid-stream."""
    from repro_torch.data import synthetic
    from repro_torch.serving.shadow import rebuild_from_params

    base = dataclasses.replace(engine_from_inputs(inputs),
                               scan_block=PLANS["pruned"])
    eng = base.shard(make_mesh((world,), ("banks",), device="cpu"), "banks")
    stream = _stream(inputs)
    data = synthetic.make_movielens(n_users=120, n_items=N_ITEMS,
                                    history_len=6)
    cat = LiveCatalog(eng, delta_capacity=N_ITEMS)
    conc = make_server(cat.engine, "concurrent", max_batch=B,
                       queue_depth=None, autostart=False)
    cat.attach(conc)
    before = cat.engine
    trainer = OnlineTrainer(cat, base.cfg, base.params, fold_every=0)
    first, second = stream[:20], stream[20:]
    got1 = _at_once(conc, first) if conc.leader else None
    losses = [trainer.step(b) for b in
              synthetic.movielens_batches(data, 64, 2, seed=1)]
    rows = trainer.fold()
    trainer.refresh_dense()
    assert rows > 0 and cat.engine is not before
    got2 = _at_once(conc, second) if conc.leader else None
    conc.close()
    want1, _ = _sync(before, first)
    want2, _ = _sync(cat.engine, second)
    if conc.leader:
        _same_tickets(got1, want1, "before the fold")
        _same_tickets(got2, want2, "after the fold")
        cold = make_server(rebuild_from_params(cat.engine, trainer.params),
                           "sync", max_batch=B)
        _same_tickets(got2, cold.serve_many(second), "a cold rebuild")
    return {"all/g/chunks": _log(conc), "all/g/losses": np.array(losses),
            "all/g/rows": np.array([rows, cat.epoch, conc.epoch])}


CASES = {"stream": rank_stream, "idle": rank_idle,
         "leader_fails": rank_leader_fails, "online": rank_online}
# the cases on a group of `SHORT_TIMEOUT_S`
SHORT = ("idle", "leader_fails")


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference():
    """The reference's engine, stream, batch and churn, and what its sync
    front-end serves on the stream -> (npz inputs, tickets, counters)."""
    import jax

    from repro.core import nns as jnns
    from repro.data import synthetic as jsyn
    from repro.models import recsys as jrs
    from repro.serving import RecSysEngine as JaxEngine
    from repro.serving import make_server as jmake_server
    from test_torch_engine import export

    data = jsyn.make_movielens(n_users=120, n_items=N_ITEMS, history_len=6)
    cfg = jrs.YoutubeDNNConfig(
        n_items=N_ITEMS,
        user_features={"user_id": data.n_users, "gender": 3, "age": 7,
                       "occupation": 21, "zip_bucket": 250},
        history_len=6)
    params = jrs.init_youtubednn(jax.random.key(0), cfg)
    freqs = np.bincount(data.histories[data.histories >= 0],
                        minlength=N_ITEMS)
    jeng = JaxEngine.build(params, cfg, radius=112, n_candidates=16,
                           top_k=5, hot_rows=32, item_freqs=freqs)
    jeng = dataclasses.replace(jeng, block_summary=jnns.build_block_summary(
        np.asarray(jeng.item_sigs), 128))
    stream = _batch(data, np.arange(37) % 29 + 40)
    inputs = engine_inputs(export(jeng))
    inputs.update(churn_inputs(_churn(np.random.default_rng(0),
                                      np.asarray(jeng.item_hot.hot_ids))))
    inputs.update({f"stream/{k}": v for k, v in stream.items()})
    inputs.update({f"batch0/{k}": v for k, v in
                   _batch(data, np.arange(B)).items()})
    server = jmake_server(dataclasses.replace(jeng, scan_block=64), "sync",
                          max_batch=B)
    want = server.serve_many(_queries(stream))
    st = server.stats()
    server.close()
    return inputs, want, np.array([st[k] for k in COUNTERS])


def _agree(outs: list) -> None:
    """Every rank's `all/` records equal rank 0's."""
    keys = sorted(k for k in outs[0] if k.startswith("all/"))
    assert keys
    for r, out in enumerate(outs[1:], 1):
        assert sorted(k for k in out if k.startswith("all/")) == keys
        for k in keys:
            np.testing.assert_array_equal(out[k], outs[0][k],
                                          err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("world", WORLDS)
def test_concurrent_stream_on_gloo_ranks(world, reference, tmp_path):
    inputs, want, want_counters = reference
    outs = spawn(__file__, "stream", world, inputs, tmp_path)
    _agree(outs)
    lead = outs[0]
    n_meshes = 0
    for mname in SHARDINGS:
        for plan in PLANS:
            key = f"{mname}/{plan}"
            n_meshes += 1
            np.testing.assert_array_equal(lead[f"all/{key}/a/counters"],
                                          want_counters, err_msg=key)
            for i, w in enumerate(want):
                _like(lead[f"lead/{key}/items"][i],
                      lead[f"lead/{key}/scores"][i], w.items, w.scores,
                      f"{key} vs the reference, query {i}")
            # every chunk is one epoch, in sequence on every rank
            for case in ("b", "c"):
                name = f"all/{key}/{case}/chunks"
                if name in lead:
                    seqs = lead[name][:, 0]
                    assert (np.diff(seqs) > 0).all(), (name, seqs)
    assert n_meshes == 6
    # a snapshot's block summary was held to the unsharded one's where the
    # banks summarize at its block rows (before the compaction grew them)
    assert lead["all/f/grid_5/summary_rows"] == 128


def test_idle_follower_and_a_failed_rank(reference, tmp_path):
    outs = spawn(__file__, "idle", 2, reference[0], tmp_path)
    _agree(outs)
    assert outs[0]["all/e/chunks"].tolist() == [[0, 0, 10], [1, 0, 10]]


def test_failed_leader_closes_every_rank(reference, tmp_path):
    outs = spawn(__file__, "leader_fails", 2, reference[0], tmp_path)
    _agree(outs)


def test_online_fold_in_the_pause_window(reference, tmp_path):
    outs = spawn(__file__, "online", 2, reference[0], tmp_path)
    _agree(outs)
    rows, epoch, swaps = outs[0]["all/g/rows"]
    # the attach swap, the fold's publication and the refresh's
    assert rows > 0 and swaps == 3
    epochs = outs[0]["all/g/chunks"][:, 1].tolist()
    assert epochs[0] == 1 and epochs[-1] == 3, epochs


# ---------------------------------------------------------------------------
# in this process: one gloo rank
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def one_rank_engine(world1, reference):
    eng = engine_from_inputs(reference[0])
    return eng, eng.shard(make_mesh((1,), ("banks",), device="cpu"),
                          "banks"), _stream(reference[0])


@pytest.mark.parametrize("bad,why", [
    ({"history": [1, 2, 3]}, "history"),
    ({"history": [1, 2, 3, 4, 5, 6.5]}, "integers"),
    ({"genre": None}, "integers"),
    ({"gender": 3}, "gender"),
    ({"history": [0, 1, 2, 3, 4, N_ITEMS]}, "history"),
    ({"user_id": [1, 2]}, "malformed"),
    ({"age": -2}, "age"),
])
def test_stream_refuses_a_malformed_chunk(one_rank_engine, bad, why):
    """Rank 0 validates a chunk before it sends it: a query the engine
    cannot serve fails the chunk there, and nothing goes down the
    stream."""
    _, eng, stream = one_rank_engine
    conc = make_server(eng, "concurrent", max_batch=B, queue_depth=None)
    stream_ = conc._stream
    query = {**stream[0], **bad}
    with pytest.raises(ValueError, match=why):
        stream_.pack([stream[1], query], eng)
    seq = stream_.seq
    res = conc.result(conc.submit(query), timeout=WAIT_S)
    assert res.status == "error" and stream_.seq == seq
    rows = stream_.pack(stream[:3], eng)
    assert rows.dtype == np.int32 and rows.shape == (3, 6 + 6)
    for q, back in zip(stream[:3], stream_.unpack(rows)):
        assert back.keys() == q.keys()
        for k in q:
            np.testing.assert_array_equal(back[k], q[k])
    conc.close()


def test_swap_onto_another_mesh_is_refused(one_rank_engine):
    local, eng, stream = one_rank_engine
    conc = make_server(eng, "concurrent", max_batch=B, queue_depth=None)
    with pytest.raises(ServerConfigError, match="another mesh"):
        conc.swap_engine(local)
    plain = make_server(local, "concurrent", max_batch=B)
    with pytest.raises(ServerConfigError, match="another mesh"):
        plain.swap_engine(eng)
    plain.close()
    conc.swap_engine(dataclasses.replace(eng))  # same mesh: one window
    assert conc.epoch == 1
    got = _at_once(conc, stream[:4])
    conc.close()
    assert _log(conc).tolist() == [[1, 1, 4]]  # the pause op was seq 0
    want, _ = _sync(eng, stream[:4])
    _same_tickets(got, want, "after a swap on one rank")


def _all_ready(directory: Path, rank: int, world: int) -> None:
    """A file barrier before the rendezvous, so a short group timeout
    does not have to cover the ranks' start-up."""
    (directory / f"ready{rank}").touch()
    deadline = time.monotonic() + 60
    while not all((directory / f"ready{r}").exists() for r in range(world)):
        if time.monotonic() > deadline:
            raise TimeoutError("the other ranks did not start")
        time.sleep(0.02)


if __name__ == "__main__":
    if sys.argv[1] in SHORT:
        import test_torch_mesh

        _all_ready(Path(sys.argv[4]), int(sys.argv[3]), int(sys.argv[2]))
        test_torch_mesh.GLOO_TIMEOUT_S = SHORT_TIMEOUT_S
    sys.exit(rank_main(CASES))
