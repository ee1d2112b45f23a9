"""The port's live catalog against the JAX reference's, on the CPU.

A `repro` engine like `tests/test_catalog.py`'s `served` fixture (90
items, radius 112, 16 candidates, top 5, 32 hot rows) is exported to a
`repro_torch` engine (`convert.engine_from_arrays`); the same seeded churn
(new ids past n, re-embedded hot rows, deletes, a delete and re-add, a
retired new id in the histories, a forced compaction) goes through
`repro.serving.LiveCatalog` and the port's `LiveCatalog`, with the update
rows and the LSH projection taken from the reference.

Checked at the port's usual tolerances: integers bit for bit (delta ids,
int8 rows and signatures, scales, tombstone mask, hot ids and rows, the
block summary, NNS ids, distances, counts and `blocks_touched`, cache
counters); CTRs within rtol 1e-6, atol 1e-7; final ids equal within the
prefix the CTR gaps decide (`tests/test_torch_engine.py`'s rule). The NNS
layer (`delta_scan`, `merge_delta_candidates`, `delta_aware_nns` on the
dense and streaming plans, masked and pruned), `update_block_summary`,
`invalidate_rows` / `pin_rows` and the pool's side-table segment (against
`delta_cached_rows` / `delta_cached_embedding_bag`) are compared on their
own. The port's live engine is also held bit for bit against its own
`rebuild_reference()` over seeded interleavings of upserts, deletes and
compactions (the reference's gate in `tests/test_catalog.py`), through
its front-ends, and through a snapshot and restore.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nns as jnns
from repro.data import synthetic as jsyn
from repro.models import recsys as jrs
from repro.serving import LiveCatalog as JLiveCatalog
from repro.serving import RecSysEngine as JaxEngine
from repro.serving import hot_cache as jhc
from repro.serving.catalog import (
    delta_cached_embedding_bag as j_delta_bag,
)
from repro.serving.catalog import delta_cached_rows as j_delta_rows
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.convert import engine_from_arrays
from repro_torch.core import nns as tnns
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.serving import (
    DeltaFullError,
    LiveCatalog,
    invalidate_rows,
    make_server,
    pin_rows,
)
from repro_torch.serving import recsys_engine as trs
from repro_torch.serving.hot_cache import INVALID_ID
from test_torch_engine import _decided_prefix, export

FLOAT_RTOL = 1e-6
N_ITEMS = 90


def _i32(x):
    """A reference array as numpy, uint32 bits viewed as int32."""
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _eq(got, want):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else got, _i32(want))


def _t(x):
    return torch.from_numpy(np.array(_i32(x)))


@pytest.fixture(scope="module")
def served():
    data = jsyn.make_movielens(n_users=120, n_items=N_ITEMS, history_len=6)
    cfg = jrs.YoutubeDNNConfig(
        n_items=data.n_items,
        user_features={"user_id": data.n_users, "gender": 3, "age": 7,
                       "occupation": 21, "zip_bucket": 250},
        history_len=6)
    params = jrs.init_youtubednn(jax.random.key(0), cfg)
    freqs = np.bincount(data.histories[data.histories >= 0],
                        minlength=data.n_items)
    jeng = JaxEngine.build(params, cfg, radius=112, n_candidates=16,
                           top_k=5, hot_rows=32, item_freqs=freqs)
    teng = engine_from_arrays(**export(jeng), device="cpu")
    return jeng, teng, data


def _rows(rng, m, d=32):
    return rng.normal(size=(m, d)).astype(np.float32)


def _batch(data, idx):
    """A stacked request batch of users `idx` (numpy)."""
    return {**{k: v[idx].astype(np.int32) for k, v in data.user_feats.items()},
            "history": data.histories[idx].astype(np.int32),
            "genre": data.genres[idx].astype(np.int32)}


# ---------------------------------------------------------------------------
# the NNS layer: delta scan, merge, delta-aware NNS, summary maintenance
# ---------------------------------------------------------------------------
def _delta_case(seed, n=500, words=8, D=64, q=9):
    """Random base signatures, queries near some of them, a delta of
    overwrites and new ids, and a tombstone mask (the reference's test)."""
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 2**32, (n, words), dtype=np.uint32)
    qs = db[rng.choice(n, q, replace=False)].copy()
    qs ^= (rng.random(qs.shape) < 0.2).astype(np.uint32) << rng.integers(
        0, 32, qs.shape).astype(np.uint32)
    over = rng.choice(n, 30, replace=False)
    ids = np.sort(np.concatenate([over, np.arange(n, n + 10)])
                  .astype(np.int32))
    delta_ids = np.full(D, jnns.EMPTY_ID, np.int32)
    delta_ids[: len(ids)] = ids
    dsigs = rng.integers(0, 2**32, (D, words), dtype=np.uint32)
    dsigs[:5] = qs[:5]  # some delta rows match
    alive = np.ones(n, bool)
    alive[over] = False
    alive[rng.choice(np.setdiff1d(np.arange(n), over), 12,
                     replace=False)] = False
    return db, qs, delta_ids, dsigs, alive


@pytest.mark.parametrize("D,k", [(64, 16), (8, 16), (64, 64)])
def test_delta_scan_matches_reference(D, k):
    """Global ids, the (distance, slot) order and free slots ignored; a
    shard smaller than K pads."""
    _, qs, delta_ids, dsigs, _ = _delta_case(1, D=max(D, 40))
    delta_ids, dsigs = delta_ids[:D], dsigs[:D]
    want = jnns.delta_scan(jnp.asarray(qs), jnp.asarray(dsigs),
                           jnp.asarray(delta_ids), 110, k)
    got = tnns.delta_scan(_t(qs), _t(dsigs), _t(delta_ids), 110, k)
    for f in ("indices", "distances", "counts"):
        _eq(getattr(got, f), getattr(want, f))
    assert int((got.indices >= 0).sum()) > 0


@pytest.mark.parametrize("plan", ["dense", "streaming", "streaming_pruned",
                                  "streaming_superblock"])
def test_delta_aware_nns_matches_reference(plan):
    """Base (tombstones masked; dense, streaming, pruned or superblocked)
    + delta + merge, bit for bit with the reference, and with a dense scan
    over the folded table."""
    db, qs, delta_ids, dsigs, alive = _delta_case(2)
    n = db.shape[0]
    kw = {"dense": dict(scan_block=0),
          "streaming": dict(scan_block=64),
          "streaming_pruned": dict(scan_block=64),
          "streaming_superblock": dict(scan_block=64, superblock=256)}[plan]
    jkw, tkw = dict(kw), dict(kw)
    if plan == "streaming_pruned":
        jkw["summary"] = jnns.build_block_summary(db, 128, db_mask=alive)
        tkw["summary"] = tnns.build_block_summary(db, 128, db_mask=alive)
    want = jnns.delta_aware_nns(
        jnp.asarray(qs), jnp.asarray(db), jnp.asarray(dsigs),
        jnp.asarray(delta_ids), 110, 16, db_mask=jnp.asarray(alive), **jkw)
    got = tnns.delta_aware_nns(
        _t(qs), _t(db), _t(dsigs), _t(delta_ids), 110, 16,
        db_mask=torch.from_numpy(alive), **tkw)
    for f in ("indices", "distances", "counts", "blocks_touched"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _eq(a, b)
    # the folded table scanned dense: the rebuild oracle
    live = delta_ids != jnns.EMPTY_ID
    folded = np.zeros((n + 10, db.shape[1]), np.uint32)
    folded[:n] = db
    folded[delta_ids[live]] = dsigs[live]
    mask = np.zeros(n + 10, bool)
    mask[:n] = alive
    mask[delta_ids[live]] = True
    dense = tnns.fixed_radius_nns(_t(qs), _t(folded), 110, 16,
                                  db_mask=torch.from_numpy(mask),
                                  scan_block=0)
    for f in ("indices", "distances", "counts"):
        assert torch.equal(getattr(got, f), getattr(dense, f)), f
    assert int((got.indices >= 0).sum()) > 0


def test_merge_delta_candidates_matches_reference():
    """Delta ids interleave with base ids; an empty delta is the identity
    (blocks touched pass through)."""
    rng = np.random.default_rng(3)
    q, k = 6, 12
    base_d = np.sort(rng.integers(0, 20, (q, k)), axis=1).astype(np.int32)
    base_i = np.stack([np.sort(rng.choice(200, k, replace=False))
                       for _ in range(q)]).astype(np.int32)
    base_i[:, -3:], base_d[:, -3:] = -1, jnns.BIG
    delta_d = np.sort(rng.integers(0, 20, (q, k)), axis=1).astype(np.int32)
    delta_i = rng.integers(200, 260, (q, k)).astype(np.int32)
    delta_i[:, 5:], delta_d[:, 5:] = -1, jnns.BIG
    bt = rng.integers(0, 4, q).astype(np.int32)
    jb = jnns.NNSResult(jnp.asarray(base_i), jnp.asarray(base_d),
                        jnp.asarray(rng.integers(0, 9, q).astype(np.int32)),
                        jnp.asarray(bt))
    jd = jnns.NNSResult(jnp.asarray(delta_i), jnp.asarray(delta_d),
                        jnp.asarray(rng.integers(0, 9, q).astype(np.int32)))
    tb = tnns.NNSResult(*(_t(x) for x in jb))
    td = tnns.NNSResult(*(_t(x) for x in jd[:3]))
    want = jnns.merge_delta_candidates(jb, jd, k)
    got = tnns.merge_delta_candidates(tb, td, k)
    for f in ("indices", "distances", "counts", "blocks_touched"):
        _eq(getattr(got, f), getattr(want, f))
    empty = tnns.NNSResult(torch.full((q, k), -1, dtype=torch.int32),
                           torch.full((q, k), tnns.BIG_DIST,
                                      dtype=torch.int32),
                           torch.zeros(q, dtype=torch.int32))
    same = tnns.merge_delta_candidates(tb, empty, k)
    for f in ("indices", "distances", "counts", "blocks_touched"):
        assert torch.equal(getattr(same, f), getattr(tb, f))


def test_update_block_summary_matches_reference():
    """Touched blocks recomputed exactly: equal to the reference's update
    and to a cold build over the new mask."""
    rng = np.random.default_rng(4)
    sigs = rng.integers(0, 2**32, (1000, 8), dtype=np.uint32)
    alive = rng.random(1000) > 0.1
    js = jnns.build_block_summary(sigs, 128, db_mask=alive)
    ts = tnns.build_block_summary(sigs, 128, db_mask=alive)
    touched = rng.choice(1000, 40, replace=False)
    alive2 = alive.copy()
    alive2[touched[:30]] = False
    alive2[touched[30:]] = True
    want = jnns.update_block_summary(js, sigs, alive2, touched)
    got = tnns.update_block_summary(ts, _t(sigs), alive2, touched)
    cold = tnns.build_block_summary(sigs, 128, db_mask=alive2)
    for f in ("or_sigs", "and_sigs", "min_pc", "max_pc", "n_alive"):
        _eq(getattr(got, f), getattr(want, f))
        assert torch.equal(getattr(got, f), getattr(cold, f))
    assert tnns.update_block_summary(ts, _t(sigs), alive2, []) is ts


def test_invalidate_and_pin_rows_match_reference(served):
    jeng, teng, _ = served
    victims = np.asarray(jeng.item_hot.hot_ids)[[1, 3, 7]]
    want = jhc.invalidate_rows(jeng.item_hot, victims)
    got = invalidate_rows(teng.item_hot, victims)
    _eq(got.hot_ids, want.hot_ids)
    _eq(got.hot_rows, want.hot_rows)
    assert got.capacity == want.capacity
    assert invalidate_rows(teng.item_hot, [10**6]) is teng.item_hot
    ids = got.hot_ids.numpy()
    keep = ids[ids != INVALID_ID]
    jpin = jhc.pin_rows(jeng.item_table_q, keep, jeng.item_hot.capacity)
    tpin = pin_rows(teng.item_table_q, keep, teng.item_hot.capacity)
    _eq(tpin.hot_ids, jpin.hot_ids)
    _eq(tpin.hot_rows, jpin.hot_rows)
    assert torch.equal(tpin.hot_rows, got.hot_rows)
    with pytest.raises(ValueError, match="capacity"):
        pin_rows(teng.item_table_q, np.arange(40), 32)


# ---------------------------------------------------------------------------
# the churn, through both catalogs
# ---------------------------------------------------------------------------
def _churn(rng, hot):
    """The seeded update batches: (kwargs list, retired id for the
    histories or None)."""
    re = np.r_[hot[:3], [20, 40]]
    return [
        ([dict(upsert_ids=np.arange(90, 96), upsert_rows=_rows(rng, 6))],
         None),
        ([dict(upsert_ids=re, upsert_rows=_rows(rng, len(re)))], None),
        ([dict(delete_ids=[7, 50, 91])], 91),
        ([dict(delete_ids=[40]),
          dict(upsert_ids=[40], upsert_rows=_rows(rng, 1))], 91),
        ([dict(upsert_ids=np.arange(96, 104), upsert_rows=_rows(rng, 8))],
         91),  # 8 + 11 pending > 16: a forced compaction
    ]


def _assert_state_equal(tcat, jcat):
    te, je = tcat.engine, jcat.engine
    assert tcat.epoch == jcat.epoch and tcat.n_pending == jcat.n_pending
    assert tcat.n_items == jcat.n_items
    for f in ("ids", "values", "scales", "sigs"):
        _eq(getattr(te.delta, f), getattr(je.delta, f))
    n = te.item_table_q.values.shape[0]
    _eq(te.item_mask, np.asarray(je.item_mask)[:n])
    _eq(te.item_table_q.values, je.item_table_q.values)
    _eq(te.item_table_q.scales, je.item_table_q.scales)
    _eq(te.item_sigs, np.asarray(je.item_sigs)[:n])
    _eq(te.item_hot.hot_ids, je.item_hot.hot_ids)
    _eq(te.item_hot.hot_rows, je.item_hot.hot_rows)
    for f in ("or_sigs", "and_sigs", "min_pc", "max_pc", "n_alive"):
        _eq(getattr(te.block_summary, f), getattr(je.block_summary, f))


def _assert_serves_like_reference(teng, jeng, batch):
    """Counters equal; given the reference's query signatures the NNS is
    equal; CTRs within 1e-6; ids equal within the decided prefix (when
    the port's own query signatures gave the same candidates). Returns
    whether the ids were compared."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jeng.serve(jb)
    got = teng.serve(batch)
    assert got.stats.as_dict() == want.stats.as_dict()
    from repro.core.lsh import lsh_signature as jlsh
    from repro.serving.recsys_engine import _features as jfeat

    q = jlsh(jax.jit(jfeat)(jeng, jb)[0], jeng.lsh_proj)
    nns = trs._nns(teng, _t(q))
    for f in ("indices", "distances", "counts", "blocks_touched"):
        a, b = getattr(nns, f), getattr(want.nns, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _eq(a, b)
    scores = np.asarray(want.topk.scores)
    np.testing.assert_allclose(got.topk.scores.numpy(), scores,
                               rtol=FLOAT_RTOL, atol=1e-7)
    n_dec = _decided_prefix(scores, 2e-6)
    same = torch.equal(got.nns.indices, nns.indices)
    if same:
        for r in range(scores.shape[0]):
            k = int(n_dec[r])
            np.testing.assert_array_equal(got.items[r, :k].numpy(),
                                          np.asarray(want.items)[r, :k])
    return same


@pytest.mark.parametrize("scan_block", [None, 64])
def test_churn_matches_reference_catalog(served, scan_block):
    """The same churn through both catalogs: equal state after every
    update batch and the compactions, and served batches as the
    reference serves them (dense and streaming plans)."""
    jeng, teng, data = served
    jeng = dataclasses.replace(jeng, scan_block=scan_block)
    teng = dataclasses.replace(teng, scan_block=scan_block)
    jcat = JLiveCatalog(jeng, delta_capacity=16)
    tcat = LiveCatalog(teng, delta_capacity=16)
    _assert_state_equal(tcat, jcat)
    rng = np.random.default_rng(10)
    idx = np.arange(24) % 60
    compared = 0
    for updates, retired in _churn(rng, np.asarray(jeng.item_hot.hot_ids)):
        for u in updates:
            jcat.apply_updates(**u)
            tcat.apply_updates(**u)
        _assert_state_equal(tcat, jcat)
        batch = _batch(data, idx)
        if retired is not None:
            batch["history"][:, 0] = retired
        compared += _assert_serves_like_reference(tcat.engine, jcat.engine,
                                                  batch)
    assert compared >= 4
    assert tcat.epoch == 1  # the last batch forced a compaction
    jcat.compact()
    tcat.compact()
    _assert_state_equal(tcat, jcat)
    _assert_serves_like_reference(tcat.engine, jcat.engine,
                                  _batch(data, idx))


def test_side_table_segment_matches_delta_cached_rows(served):
    """The pool segment with the delta as its side table against the
    reference's `delta_cached_rows` (rows mode, bit for bit) and
    `delta_cached_embedding_bag` (mean, within 1e-6), counters equal:
    delta hits, hot hits, ids past the base (zeros), padding."""
    jeng, teng, _ = served
    rng = np.random.default_rng(11)
    jcat = JLiveCatalog(jeng, delta_capacity=16)
    tcat = LiveCatalog(teng, delta_capacity=16)
    hot = np.asarray(jeng.item_hot.hot_ids)
    for cat in (jcat, tcat):
        r = np.random.default_rng(12)
        cat.upsert(np.r_[hot[:2], 5, 92, 95], _rows(r, 5))
        cat.delete([95])
    je, te = jcat.engine, tcat.engine
    ids = rng.integers(-1, 100, (20, 6)).astype(np.int32)
    ids[0, :3] = [5, 92, 95]
    rows_j, st_j = j_delta_rows(je.delta, je.item_hot, je.item_table_q,
                                jnp.asarray(ids))
    bag_j, _ = j_delta_bag(je.delta, je.item_hot, je.item_table_q,
                           jnp.asarray(ids), mode="mean")
    plan = te.rank_plan
    seg = plan.segments[0]
    assert seg.side is not None and seg.side.ids.shape == (16,)
    for mode in ("rows", "mean"):
        s = seg._replace(mode=mode, column=0)
        out = (torch.zeros((20, 6, 32)) if mode == "rows"
               else torch.zeros((20, 32)))
        counts = ops.grouped_pool(ops.PoolPlan([s]), [torch.from_numpy(ids)],
                                  [out])
        assert [int(c) for c in counts] == [int(st_j.hits),
                                            int(st_j.lookups)]
        if mode == "rows":
            _eq(out, rows_j)
        else:
            np.testing.assert_allclose(out.numpy(), np.asarray(bag_j),
                                       rtol=FLOAT_RTOL, atol=1e-7)
    assert int(st_j.hits) > 0 and (np.asarray(rows_j)[0, 2] == 0).all()


# ---------------------------------------------------------------------------
# the port's own gates: rebuild reference, front-ends, snapshot
# ---------------------------------------------------------------------------
def _serve(engine, queries, max_batch=8):
    server = make_server(engine, "sync", max_batch=max_batch)
    out = server.serve_many(queries)
    st = server.stats()
    return (np.stack([o.items for o in out]),
            np.stack([o.scores for o in out]),
            (st["cache_hits"], st["cache_lookups"]))


def _assert_matches_rebuild(cat, queries):
    items, scores, stats = _serve(cat.engine, queries)
    r_items, r_scores, r_stats = _serve(cat.rebuild_reference(), queries)
    np.testing.assert_array_equal(items, r_items)
    np.testing.assert_array_equal(scores, r_scores)
    assert stats == r_stats
    return items, scores, stats


@pytest.mark.parametrize("seed", range(6))
def test_any_churn_interleaving_matches_rebuild(served, seed):
    """Seeded interleavings of upserts (overlapping, past the base,
    re-adds), deletes and compactions, the delta overflowing mid-way:
    the live catalog serves its `rebuild_reference()`'s bits."""
    _, teng, data = served
    rng = np.random.default_rng(100 + seed)
    queries = synthetic.serving_queries(data, np.arange(15) % 60)
    cat = LiveCatalog(dataclasses.replace(
        teng, scan_block=None if seed % 2 else 64), delta_capacity=8)
    for _ in range(int(rng.integers(2, 7))):
        kind = rng.choice(["upsert", "upsert", "delete", "compact"])
        ids = rng.choice(100, int(rng.integers(1, 5)), replace=False)
        if kind == "upsert":
            cat.upsert(ids, _rows(rng, len(ids)))
        elif kind == "delete":
            cat.delete(ids)
        else:
            cat.compact()
        _assert_matches_rebuild(cat, queries)


def test_catalog_publishes_to_front_ends(served):
    """Sync and pipelined (depth 3) servers attached to one catalog serve
    equal bits across updates; a compaction under the ring leaves the
    buckets dispatched before it on the old epoch and the rest on the
    new one; `observe` counts the served lookups."""
    _, teng, data = served
    rng = np.random.default_rng(13)
    cat = LiveCatalog(teng, delta_capacity=16)
    sync = make_server(cat.engine, "sync", max_batch=8)
    pipe = make_server(cat.engine, "pipelined", max_batch=8, depth=3)
    cat.attach(sync)
    cat.attach(pipe)
    queries = synthetic.serving_queries(data, np.arange(40) % 60)
    cat.upsert(np.arange(90, 94), _rows(rng, 4))
    a, b = sync.serve_many(queries), pipe.serve_many(queries)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.items, y.items)
        np.testing.assert_array_equal(x.scores, y.scores)
    assert cat.n_observed > 0 and cat.item_freqs.shape[0] >= 94
    old_ref = cat.rebuild_reference()
    tickets = [pipe.submit(q) for q in queries]
    for _ in range(2):
        pipe._ring.append(pipe._dispatch(pipe._take_parts()))
    cat.upsert(np.arange(94, 98), _rows(rng, 4))
    cat.compact()
    new_ref = cat.rebuild_reference()
    pipe.flush()
    got = np.stack([pipe.result(t).items for t in tickets])
    np.testing.assert_array_equal(got[:16], _serve(old_ref, queries)[0][:16])
    np.testing.assert_array_equal(got[16:], _serve(new_ref, queries)[0][16:])
    snap = sync.snapshot()
    assert snap["catalog.epoch"] == 1 and snap["catalog.compactions"] == 1


def test_delta_full_and_frozen_guards(served):
    """A full delta forces a compaction (the update still lands); with
    auto_compact=False it raises; a batch larger than the shard never
    fits; a frozen engine refuses updates, and an empty live view serves
    the frozen engine's bits."""
    _, teng, data = served
    rng = np.random.default_rng(14)
    queries = synthetic.serving_queries(data, np.arange(9) % 60)
    cat = LiveCatalog(teng, delta_capacity=4)
    cat.upsert([0, 1, 2], _rows(rng, 3))
    cat.upsert([3, 4], _rows(rng, 2))
    assert cat.epoch == 1 and cat.n_pending == 2
    _assert_matches_rebuild(cat, queries)
    frozen = LiveCatalog(teng, delta_capacity=4, auto_compact=False)
    frozen.upsert([0, 1, 2], _rows(rng, 3))
    with pytest.raises(DeltaFullError):
        frozen.upsert([3, 4], _rows(rng, 2))
    with pytest.raises(DeltaFullError):
        cat.upsert(np.arange(5), _rows(rng, 5))
    with pytest.raises(ValueError, match="delta"):
        teng.apply_updates(upsert_ids=[0], upsert_rows=_rows(rng, 1))
    with pytest.raises(ValueError, match="ids"):
        cat.upsert([-1], _rows(rng, 1))
    a, b = _serve(teng, queries), _serve(teng.live(8), queries)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]


def test_snapshot_restore_roundtrip(served, tmp_path):
    """A snapshot through the checkpointer restores the exact engine
    (base, delta, tombstones, caches) and its served bits."""
    _, teng, data = served
    rng = np.random.default_rng(15)
    queries = synthetic.serving_queries(data, np.arange(17) % 60)
    cat = LiveCatalog(teng, delta_capacity=16)
    cat.upsert([5, 6, 90], _rows(rng, 3))
    cat.compact()
    cat.delete([7])
    cat.upsert([8], _rows(rng, 1))
    want = _serve(cat.engine, queries)
    cat.snapshot(tmp_path)
    other = LiveCatalog(cat.engine, delta_capacity=16)
    other.delete([9])
    other.restore(tmp_path)
    assert other.epoch == 1
    got = _serve(other.engine, queries)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    for f in ("ids", "values", "scales", "sigs"):
        assert torch.equal(getattr(other.engine.delta, f),
                           getattr(cat.engine.delta, f))
    assert torch.equal(other.engine.item_mask, cat.engine.item_mask)


def test_checkpointer_atomic_and_checked(tmp_path):
    """Nested dicts, lists, NamedTuples and dataclasses of tensors
    (bfloat16 too), arrays and numpy scalars round-trip; a torn leaf fails
    its CRC32; uncommitted directories are never the latest; the async
    checkpointer keeps the newest `keep` steps."""
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": [np.ones((2, 2), np.float32),
                  torch.tensor([1.5, -2.0], dtype=torch.bfloat16)],
            "n": np.int64(7), "meta": "kept", "delta":
            trs.CacheStats(hits=torch.tensor(3), lookups=torch.tensor(9))}
    ckpt.save(tmp_path, 3, tree)
    (tmp_path / "step_00000009.tmp-dead").mkdir()
    assert ckpt.latest_step(tmp_path) == 3
    zero = {"a": torch.zeros(1, dtype=torch.int32),
            "b": [np.zeros(1, np.float32),
                  torch.zeros(1, dtype=torch.bfloat16)],
            "n": np.int64(0), "meta": "kept", "delta":
            trs.CacheStats(hits=torch.tensor(0), lookups=torch.tensor(0))}
    back = ckpt.restore(tmp_path, 3, zero)
    assert torch.equal(back["a"], tree["a"])
    assert np.array_equal(back["b"][0], tree["b"][0])
    assert torch.equal(back["b"][1], tree["b"][1])
    assert back["b"][1].dtype == torch.bfloat16
    assert back["n"] == 7 and back["meta"] == "kept"
    assert int(back["delta"].lookups) == 9
    leaf = tmp_path / "step_00000003" / "a.npy"
    arr = np.load(leaf)
    arr[0, 0] = 99
    np.save(leaf, arr)
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(tmp_path, 3, zero)
    c = ckpt.Checkpointer(tmp_path / "run", keep=2, async_=True)
    for step in range(4):
        c.save(step, {"x": torch.full((3,), step)})
    c.wait()
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "step_00000002", "step_00000003"]
    step, got = c.restore_latest({"x": torch.zeros(3)})
    assert step == 3 and torch.equal(got["x"], torch.full((3,), 3))
