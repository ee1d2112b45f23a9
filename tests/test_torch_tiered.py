"""The port's tiered out-of-core catalog against the JAX reference, on the
CPU.

The engine is `tests/test_tiered_catalog.py`'s (90 items, 16 hot rows,
16 candidates, top 5), built by the reference and exported to the port
(`convert.engine_from_arrays`). Both catalogs spill it to a base shard in
a temporary directory and serve it tiered.

Checked: the shard format (the reference opens the port's shard, and a
compaction writes the same bytes on both sides); the tier state after
every update and compaction equal to the reference's bit for bit (delta,
tombstones, pool and hot membership, hot rows, block summary); the port's
tiered serve equal, bit for bit with its counters, to its
`to_ram_engine()` and `rebuild_reference()` through a churn matrix and a
forced compaction; against the reference's tiered serve, the counters
equal, the NNS equal given the reference's query signatures, CTRs within
1e-6; `observe` and `rebalance` never changing results; snapshot and
restore; and `streaming_nns_outofcore` equal to the resident
`streaming_nns` with the same mask and prune mask, and to the reference's
out-of-core scan. Temporary directories only; nothing here waits.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nns as jnns
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro.models import recsys as jrs
from repro.serving import MicroBatcher as JMicroBatcher
from repro.serving import RecSysEngine as JaxEngine
from repro.serving import TieredCatalog as JTieredCatalog
from repro.serving import open_base_shard as j_open_base_shard
from repro_torch.convert import engine_from_arrays
from repro_torch.core import nns as tnns
from repro_torch.kernels import ops
from repro_torch.serving import (
    TieredCatalog,
    open_base_shard,
    write_base_shard,
)
from repro_torch.serving.tiered import pread_rows
from test_torch_engine import _decided_prefix, export

FLOAT_RTOL = 1e-6
SUMMARY = ("or_sigs", "and_sigs", "min_pc", "max_pc", "n_alive")


def _i32(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _eq(got, want):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else _i32(got),
        _i32(want))


@pytest.fixture(scope="module")
def served():
    data = jsyn.make_movielens(n_users=60, n_items=90, history_len=6)
    cfg = jrs.YoutubeDNNConfig(
        n_items=data.n_items,
        user_features={"user_id": data.n_users, "gender": 3, "age": 7,
                       "occupation": 21, "zip_bucket": 250},
        history_len=6)
    params = jrs.init_youtubednn(jax.random.key(0), cfg)
    freqs = np.bincount(data.histories[data.histories >= 0],
                        minlength=data.n_items)
    jeng = JaxEngine.build(params, cfg, radius=112, n_candidates=16,
                           top_k=5, hot_rows=16, item_freqs=freqs)
    teng = engine_from_arrays(**export(jeng), device="cpu")
    return jeng, teng, data, freqs


def _batch(jeng, data, idx, bucket=16):
    queries = jsyn.serving_queries(data, np.asarray(idx))
    return JMicroBatcher(jeng)._stack_np(list(queries), bucket)


def _rows(rng, m, d=32):
    return rng.normal(size=(m, d)).astype(np.float32)


def _assert_serves_match(cat, batch):
    """Tiered == all-RAM == rebuilt reference, bit for bit, counters
    included. Returns the tiered result."""
    got = cat.serve(batch)
    for oracle in (cat.to_ram_engine(), cat.rebuild_reference()):
        want = oracle.serve(batch)
        for f in ("indices", "distances", "counts"):
            assert torch.equal(getattr(got.nns, f), getattr(want.nns, f)), f
        assert torch.equal(got.items, want.items)
        assert torch.equal(got.topk.scores, want.topk.scores)
        assert got.stats.as_dict() == want.stats.as_dict()
    return got


def _assert_state_equal(tcat, jcat):
    assert tcat.epoch == jcat.epoch and tcat.n_pending == jcat.n_pending
    assert tcat.n_items == jcat.n_items
    for f in ("ids", "values", "scales", "sigs"):
        _eq(getattr(tcat.delta, f), getattr(jcat.delta, f))
    np.testing.assert_array_equal(tcat.alive, jcat.alive)
    np.testing.assert_array_equal(tcat.pool_ids, jcat.pool_ids)
    np.testing.assert_array_equal(tcat.pool_vals, jcat.pool_vals)
    _eq(tcat.inner.item_hot.hot_ids, jcat.inner.item_hot.hot_ids)
    _eq(tcat.inner.item_hot.hot_rows, jcat.inner.item_hot.hot_rows)
    for f in SUMMARY:
        _eq(getattr(tcat.summary, f), getattr(jcat.summary, f))


def _sync_freqs(tcat, jcat):
    """The reference's lookup counters into the port's catalog. Both count
    the served final ids, which may differ past the prefix the CTR gaps
    decide (float noise, `_assert_serves_like_reference`), and the port
    is served more often here (its own oracles); the ranking that the
    next compaction's rebalance makes must start from equal counters."""
    tcat.item_freqs = jcat.item_freqs.copy()
    tcat.n_observed = jcat.n_observed


def _assert_serves_like_reference(tcat, jcat, batch):
    """Counters and tier telemetry equal; the NNS equal given the
    reference's query signatures; CTRs within 1e-6; ids within the
    decided prefix."""
    def tiers(c):
        return np.array([c.pool_hits, c.delta_hits, c.disk_rows])

    t0, j0 = tiers(tcat), tiers(jcat)
    want = jcat.serve({k: np.asarray(v) for k, v in batch.items()})
    got = tcat.serve(batch)
    tiers_equal = np.array_equal(tiers(tcat) - t0, tiers(jcat) - j0)
    assert got.stats.as_dict() == {
        "hits": int(want.stats.hits), "lookups": int(want.stats.lookups),
        "hit_rate": int(want.stats.hits) / max(int(want.stats.lookups), 1)}
    from repro.core.lsh import lsh_signature as jlsh
    from repro.serving.tiered import _tiered_lookup_jit

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    q = jlsh(_tiered_lookup_jit(jcat.inner, jb, *jcat._build_overlay(
        np.asarray(batch["history"])))[0], jcat.inner.lsh_proj)
    nns = tnns.out_of_core_nns(
        torch.from_numpy(np.array(q).view(np.int32)), tcat.base.sigs,
        tcat.inner.radius, tcat.inner.n_candidates, db_mask=tcat.alive,
        summary=tcat.summary)
    pending = tnns.delta_scan(nns.indices.new_tensor(_i32(q)),
                              tcat.delta.sigs, tcat.delta.ids,
                              tcat.inner.radius, tcat.inner.n_candidates)
    nns = tnns.merge_delta_candidates(nns, pending, tcat.inner.n_candidates)
    for f in ("indices", "distances", "counts", "blocks_touched"):
        _eq(getattr(nns, f), getattr(want.nns, f))
    scores = np.asarray(want.topk.scores)
    np.testing.assert_allclose(got.topk.scores.numpy(), scores,
                               rtol=FLOAT_RTOL, atol=1e-7)
    if torch.equal(got.nns.indices, nns.indices):
        # the host's byte resolution took the same tiers on both sides
        assert tiers_equal
        n_dec = _decided_prefix(scores, 2e-6)
        for r in range(scores.shape[0]):
            k = int(n_dec[r])
            np.testing.assert_array_equal(got.items[r, :k].numpy(),
                                          np.asarray(want.items)[r, :k])
        return True
    return False


# ---------------------------------------------------------------------------
# base shard
# ---------------------------------------------------------------------------
def test_base_shard_roundtrip_and_reference_format(tmp_path):
    rng = np.random.default_rng(0)
    vals = rng.integers(-128, 128, size=(300, 8), dtype=np.int8)
    scales = rng.random((300, 1)).astype(np.float32)
    sigs = rng.integers(0, 2**32, (300, 4), dtype=np.uint32)
    alive = rng.random(300) > 0.2
    summary = tnns.build_block_summary(sigs, 128, db_mask=alive)
    write_base_shard(str(tmp_path / "s"), vals, scales, sigs, alive=alive,
                     summary=summary)
    shard, a, s = open_base_shard(str(tmp_path / "s"))
    assert (shard.n, shard.d, shard.words) == (300, 8, 4)
    assert isinstance(shard.sigs, np.memmap)
    np.testing.assert_array_equal(shard.values, vals)
    np.testing.assert_array_equal(shard.scales, scales)
    np.testing.assert_array_equal(shard.sigs, sigs)
    np.testing.assert_array_equal(a, alive)
    for f in SUMMARY:
        assert torch.equal(getattr(s, f), getattr(summary, f))
    ids = np.array([5, 0, 299, 5, 17])
    np.testing.assert_array_equal(pread_rows(shard.values, ids), vals[ids])
    np.testing.assert_array_equal(pread_rows(shard.scales, ids),
                                  scales[ids])
    # the reference reads the port's shard
    jshard, ja, js = j_open_base_shard(str(tmp_path / "s"))
    np.testing.assert_array_equal(np.asarray(jshard.sigs), sigs)
    np.testing.assert_array_equal(ja, alive)
    for f in SUMMARY:
        _eq(getattr(s, f), getattr(js, f))


# ---------------------------------------------------------------------------
# the tiered catalog against the reference's and its own oracles
# ---------------------------------------------------------------------------
def _both(served, tmp_path, **kw):
    jeng, teng, _, freqs = served
    jcat = JTieredCatalog.from_engine(jeng, str(tmp_path / "j"),
                                      item_freqs=freqs.astype(np.int64),
                                      **kw)
    tcat = TieredCatalog.from_engine(teng, str(tmp_path / "t"),
                                     item_freqs=freqs.astype(np.int64),
                                     **kw)
    return jcat, tcat


def _same_shard_bytes(tcat, jcat):
    for name in ("values.int8.bin", "scales.f32.bin", "sigs.u32.bin",
                 "alive.npy"):
        with open(os.path.join(tcat.base.directory, name), "rb") as f:
            a = f.read()
        with open(os.path.join(jcat.base.directory, name), "rb") as f:
            b = f.read()
        assert a == b, name


def test_tiered_matches_allram_and_reference_tiered(served, tmp_path):
    """Opened from the same engine: the same shard bytes and tier state
    as the reference's catalog; served batches equal to the port's
    all-RAM engine and rebuilt reference, and like the reference's."""
    jeng, _, data, _ = served
    jcat, tcat = _both(served, tmp_path, pool_rows=40, delta_capacity=8)
    _same_shard_bytes(tcat, jcat)
    _assert_state_equal(tcat, jcat)
    np.testing.assert_array_equal(tcat.item_freqs, jcat.item_freqs)
    assert tcat.pool_ids.size == 40
    compared = 0
    for lo in (0, 16, 32):
        batch = _batch(jeng, data, range(lo, lo + 12))
        _assert_serves_match(tcat, batch)
        compared += _assert_serves_like_reference(tcat, jcat, batch)
    assert compared >= 2


def test_churn_matrix_and_compaction_match_reference(served, tmp_path):
    """The same churn on both catalogs (hot and pool rows re-embedded,
    new ids past n, deletes of promoted rows, a delete and re-add, an
    overflow forcing a compaction, an explicit compaction): equal tier
    state and shard bytes after each step, and every serve equal to the
    port's own oracles."""
    jeng, _, data, _ = served
    jcat, tcat = _both(served, tmp_path, pool_rows=24, delta_capacity=8)
    rng = np.random.default_rng(1)
    hot = tcat.inner.item_hot.hot_ids.numpy()
    steps = [
        dict(upsert_ids=np.r_[hot[:2], tcat.pool_ids[-2:], 91],
             upsert_rows=_rows(rng, 5)),
        dict(delete_ids=np.r_[hot[2:4], 91]),
        dict(delete_ids=[hot[0]]),
        dict(upsert_ids=[hot[0]], upsert_rows=_rows(rng, 1)),
        dict(upsert_ids=np.arange(92, 97), upsert_rows=_rows(rng, 5)),
    ]
    for i, step in enumerate(steps):
        _sync_freqs(tcat, jcat)
        jcat.apply_updates(**step)
        tcat.apply_updates(**step)
        _assert_state_equal(tcat, jcat)
        batch = _batch(jeng, data, range(4 * i, 4 * i + 12))
        batch["history"][:, 0] = 91  # a retired new id
        _assert_serves_match(tcat, batch)
        _assert_serves_like_reference(tcat, jcat, batch)
    assert tcat.epoch == 1  # the last step overflowed the delta
    _same_shard_bytes(tcat, jcat)
    _sync_freqs(tcat, jcat)
    jcat.compact()
    tcat.compact()
    assert tcat.epoch == 2 and tcat.n_pending == 0
    _same_shard_bytes(tcat, jcat)
    _assert_state_equal(tcat, jcat)
    _assert_serves_match(tcat, _batch(jeng, data, range(12)))


def test_forced_compaction_and_guards(served, tmp_path):
    """A full delta forces a compaction (the update lands after it);
    `auto_compact=False` raises; results equal the rebuilt reference."""
    from repro_torch.serving import DeltaFullError

    jeng, teng, data, _ = served
    rng = np.random.default_rng(2)
    cat = TieredCatalog.from_engine(teng, str(tmp_path / "a"), pool_rows=16,
                                    delta_capacity=4)
    cat.upsert([1, 2, 3], _rows(rng, 3))
    cat.upsert([4, 5], _rows(rng, 2))
    assert cat.epoch == 1 and cat.n_pending == 2
    _assert_serves_match(cat, _batch(jeng, data, range(10)))
    strict = TieredCatalog.from_engine(teng, str(tmp_path / "b"),
                                       pool_rows=16, delta_capacity=4,
                                       auto_compact=False)
    strict.upsert([1, 2, 3], _rows(rng, 3))
    with pytest.raises(DeltaFullError):
        strict.upsert([4, 5], _rows(rng, 2))
    with pytest.raises(ValueError, match="hot capacity"):
        TieredCatalog.from_engine(teng, str(tmp_path / "c"), pool_rows=8)


def test_observe_and_rebalance_never_change_results(served, tmp_path):
    """Measured traffic moves the tiers (`rebalance`): hits move, results
    do not."""
    jeng, teng, data, _ = served
    cat = TieredCatalog.from_engine(teng, str(tmp_path / "a"), pool_rows=16)
    batch = _batch(jeng, data, range(12))
    before = _assert_serves_match(cat, batch)
    hot0 = cat.inner.item_hot.hot_ids.clone()
    skew = np.repeat(np.arange(60, 90), 50)
    cat.observe(skew)
    cat.observe(np.array([-1, 2**31 - 1]))  # padding and sentinels ignored
    assert cat.n_observed >= skew.size
    cat.rebalance()
    assert not torch.equal(cat.inner.item_hot.hot_ids, hot0)
    after = _assert_serves_match(cat, batch)
    assert torch.equal(before.items, after.items)
    assert torch.equal(before.topk.scores, after.topk.scores)
    assert torch.equal(before.nns.indices, after.nns.indices)


def test_snapshot_restore_and_guards(served, tmp_path):
    """The sidecar snapshot (delta, tombstones, frequencies) restores into
    a freshly opened catalog: equal counters, the same tiers, the same
    served bits; an empty directory and an epoch mismatch are refused."""
    jeng, teng, data, _ = served
    rng = np.random.default_rng(3)
    shard_dir = str(tmp_path / "shard")
    cat = TieredCatalog.from_engine(teng, shard_dir, pool_rows=24,
                                    delta_capacity=8)
    with pytest.raises(FileNotFoundError, match="no committed snapshot"):
        cat.restore(tmp_path / "empty")
    for lo in (0, 12):
        _assert_serves_match(cat, _batch(jeng, data, range(lo, lo + 12)))
    cat.upsert([1, 2, 92], _rows(rng, 3))
    cat.delete([3])
    cat.compact()
    cat.upsert([5, 94], _rows(rng, 2))
    cat.delete([7])
    cat.snapshot(tmp_path / "snap")
    other = TieredCatalog.open(shard_dir, teng, pool_rows=24,
                               delta_capacity=8)
    other.restore(tmp_path / "snap")
    np.testing.assert_array_equal(other.item_freqs, cat.item_freqs)
    np.testing.assert_array_equal(other.alive, cat.alive)
    assert other.n_observed == cat.n_observed
    cat.rebalance()
    np.testing.assert_array_equal(other.pool_ids, cat.pool_ids)
    assert torch.equal(other.inner.item_hot.hot_ids,
                       cat.inner.item_hot.hot_ids)
    for f in SUMMARY:
        assert torch.equal(getattr(other.summary, f), getattr(cat.summary, f))
    batch = _batch(jeng, data, range(8, 20))
    want, got = cat.serve(batch), other.serve(batch)
    assert torch.equal(want.items, got.items)
    assert torch.equal(want.topk.scores, got.topk.scores)
    assert want.stats.as_dict() == got.stats.as_dict()
    fresh = TieredCatalog.from_engine(teng, str(tmp_path / "b"),
                                      pool_rows=24, delta_capacity=8)
    with pytest.raises(ValueError, match="does not match the opened"):
        fresh.restore(tmp_path / "snap")


# ---------------------------------------------------------------------------
# the out-of-core scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pruned,chunk,n_valid", [
    (False, 1 << 10, None), (True, 1 << 9, None), (True, 1 << 8, 2500),
    (False, 700, 3000)])
def test_streaming_nns_outofcore_matches_resident(tmp_path, pruned, chunk,
                                                  n_valid):
    """Chunked out of core (a memmap, zero-padded chunks, the row remap)
    == the resident streaming scan with the same mask and prune mask ==
    the reference's out-of-core scan."""
    rng = np.random.default_rng(chunk)
    n, q, words, br = 3000, 7, 8, 256
    db = rng.integers(0, 2**32, (n, words), dtype=np.uint32)
    db[1000:1040] = db[0]  # duplicate rows: ties broken by row
    mm = np.memmap(tmp_path / "sigs.bin", dtype=np.uint32, mode="w+",
                   shape=(n, words))
    mm[:] = db
    mm.flush()
    qs = db[rng.choice(n, q, replace=False)].copy()
    qs[0] = db[0]
    alive = rng.random(n) > 0.1
    kw = dict(radius=100, max_candidates=20, n_valid=n_valid,
              db_mask=alive)
    prune = None
    if pruned:
        clustered = np.zeros_like(db)  # blocks far from every query
        clustered[:] = 0xFFFFFFFF
        db_p = np.where((np.arange(n) // br % 3 == 1)[:, None], clustered,
                        db)
        mm[:] = db_p
        mm.flush()
        db = db_p
        summary = tnns.build_block_summary(db, br, db_mask=alive)
        prune, _ = tnns._prune_mask(torch.from_numpy(qs.view(np.int32)),
                                    summary, 100)
        prune = prune.numpy()
        assert prune.all(axis=0).any()  # some blocks are never read
        kw.update(prune_blocks=prune, prune_block_rows=br)
    tq = torch.from_numpy(qs.view(np.int32))
    got = ops.streaming_nns_outofcore(tq, mm, chunk_rows=chunk, **kw)
    res_kw = dict(kw, db_mask=torch.from_numpy(alive))
    if pruned:
        res_kw["prune_blocks"] = torch.from_numpy(prune)
    want = ops.streaming_nns(tq, torch.from_numpy(db.view(np.int32)),
                             **res_kw)
    ref = jops.streaming_nns_outofcore(jnp.asarray(qs), mm,
                                       chunk_rows=chunk, **kw)
    for g, w, r in zip(got, want, ref):
        assert torch.equal(g, w)
        _eq(g, r)
    assert int((got[0] >= 0).sum()) > 0


def test_fixed_radius_nns_routes_a_memmap(tmp_path):
    """`fixed_radius_nns` on an `np.memmap` scans out of core; the result,
    `blocks_touched` included, equals the resident pruned scan's."""
    rng = np.random.default_rng(5)
    db = rng.integers(0, 2**32, (5000, 8), dtype=np.uint32)
    mm = np.memmap(tmp_path / "s.bin", dtype=np.uint32, mode="w+",
                   shape=db.shape)
    mm[:] = db
    mm.flush()
    alive = rng.random(5000) > 0.05
    summary = tnns.build_block_summary(db, 1024, db_mask=alive)
    qs = torch.from_numpy(db[[3, 4000, 77]].view(np.int32))
    got = tnns.fixed_radius_nns(qs, mm, 96, 10, db_mask=alive,
                                summary=summary)
    want = tnns.fixed_radius_nns(qs, torch.from_numpy(db.view(np.int32)),
                                 96, 10, db_mask=torch.from_numpy(alive),
                                 scan_block=1024, summary=summary)
    for f in ("indices", "distances", "counts", "blocks_touched"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    jw = jnns.out_of_core_nns(jnp.asarray(db[[3, 4000, 77]]), mm, 96, 10,
                              db_mask=alive, summary=jnns.build_block_summary(
                                  db, 1024, db_mask=alive))
    for f in ("indices", "distances", "counts", "blocks_touched"):
        _eq(getattr(got, f), getattr(jw, f))
