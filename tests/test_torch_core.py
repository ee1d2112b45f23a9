"""The port's core and cache layers against the JAX reference, on the CPU.

Each case feeds the same numpy inputs to a `repro` function (auto `ref`
backend, as the reference's own CPU tests run it) and to its counterpart
in `repro_torch`. Integer results — quantized values, signatures, NNS
candidates and their order, counts, `blocks_touched`, cache counters —
must be equal bit for bit. Float results that the port computes with the
same single IEEE operations (dequantized rows, cached rows) must be equal
too; reductions in another order (pooling over L slots, matmuls) are held
to 1e-6 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedding as jemb
from repro.core import lsh as jlsh
from repro.core import nns as jnns
from repro.core import quantization as jquant
from repro.core import topk as jtopk
from repro.models import recsys as jrs
from repro.serving import catalog as jcat
from repro.serving import hot_cache as jhot
from repro_torch.core import embedding as temb
from repro_torch.core import lsh as tlsh
from repro_torch.core import nns as tnns
from repro_torch.core import quantization as tquant
from repro_torch.core import topk as ttopk
from repro_torch.kernels import ref as tref
from repro_torch.models import recsys as trs
from repro_torch.serving import catalog as tcat
from repro_torch.serving import hot_cache as thot

FLOAT_RTOL = 1e-6

# the reference under `jax.jit`, as its engine runs it (one compile per
# shape instead of one per primitive keeps these tests fast)
_jit_nns = jax.jit(jnns.fixed_radius_nns, static_argnums=(2, 3),
                   static_argnames=("scan_block", "n_valid", "superblock",
                                    "prune"))
_jit_cached_rows = jax.jit(jhot.cached_rows)
_jit_delta_rows = jax.jit(jcat.delta_rows)
_jit_delta_cached_rows = jax.jit(jcat.delta_cached_rows)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    np.testing.assert_array_equal(got, want)


def _qt_pair(rng, n, d):
    dense = (0.05 * rng.standard_normal((n, d))).astype(np.float32)
    return (jquant.quantize_rowwise(jnp.asarray(dense)),
            tquant.quantize_rowwise(_t(dense)))


# ---------------------------------------------------------------------------
# quantization and embedding bags
# ---------------------------------------------------------------------------
def test_round_is_half_to_even_like_jnp():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32)
    _eq(torch.round(_t(x)), jnp.round(jnp.asarray(x)))
    assert torch.round(_t(x)).tolist() == [0, 2, 2, -0, -2, -2, 4]


@pytest.mark.parametrize("n,d", [(1, 32), (300, 32), (17, 7)])
def test_quantize_rowwise_bit_equal(n, d):
    rng = np.random.default_rng(n * d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[0, :3] = [0.5, -0.5, 0.0]  # exact ties after scaling are possible
    jq, tq = jquant.quantize_rowwise(jnp.asarray(x)), \
        tquant.quantize_rowwise(_t(x))
    _eq(tq.values, jq.values)
    _eq(tq.scales, jq.scales)
    _eq(tquant.dequantize_rowwise(tq), jquant.dequantize_rowwise(jq))


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_lookup_and_embedding_bag(mode, weighted):
    rng = np.random.default_rng(4)
    jq, tq = _qt_pair(rng, 60, 32)
    ids = rng.integers(-1, 60, size=(9, 20)).astype(np.int32)
    _eq(temb.lookup(tq, _t(ids)), jemb.lookup(jq, jnp.asarray(ids)))
    w = rng.random((9, 20)).astype(np.float32) if weighted else None
    got = temb.embedding_bag(tq, _t(ids), None if w is None else _t(w),
                             mode=mode)
    want = jemb.embedding_bag(jq, jnp.asarray(ids),
                              None if w is None else jnp.asarray(w),
                              mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FLOAT_RTOL, atol=1e-7)


# ---------------------------------------------------------------------------
# LSH signatures and top-k
# ---------------------------------------------------------------------------
def test_pack_and_unpack_bits_equal_reference():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, size=(5, 3, 256)).astype(np.int32)
    bits[0, 0, :] = 1  # all-ones word: the int32 -1 holding 0xFFFFFFFF
    packed = tlsh.pack_bits(_t(bits))
    _eq(packed, jlsh.pack_bits(jnp.asarray(bits)))
    _eq(tlsh.unpack_bits(packed, 256), bits)
    _eq(tlsh.unpack_bits(packed, 200),
        jlsh.unpack_bits(jlsh.pack_bits(jnp.asarray(bits)), 200))


def test_lsh_signature_differs_only_where_projections_round_near_zero():
    """Given the same floats the signatures are equal; from a float32
    matmul each framework computes, a bit may flip only where |x @ proj|
    is within rounding of 0 (`repro/core/lsh.py:47`)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    proj = rng.standard_normal((32, 256)).astype(np.float32)
    y = x @ proj
    _eq(tlsh.pack_bits(_t(y) >= 0.0),
        jlsh.pack_bits((jnp.asarray(y) >= 0.0).astype(jnp.uint32)))
    got = tlsh.unpack_bits(tlsh.lsh_signature(_t(x), _t(proj)), 256)
    want = np.asarray(jlsh.unpack_bits(
        jlsh.lsh_signature(jnp.asarray(x), jnp.asarray(proj)), 256))
    near_zero = np.abs(y) <= 1e-4 * np.abs(x).sum(1, keepdims=True) * \
        np.abs(proj).max()
    assert np.array_equal(got.numpy()[~near_zero], want[~near_zero])


def test_threshold_topk_breaks_ties_to_the_lower_index():
    scores = np.array([[0.3, 0.9, 0.3, 0.9, 0.1, 0.3],
                       [0.2, 0.2, 0.2, 0.2, 0.2, 0.2],
                       [-np.inf, 0.5, -np.inf, 0.5, 0.4, 0.5]], np.float32)
    for k, thr in [(4, 0.0), (6, 0.25), (9, 0.0)]:
        got = ttopk.threshold_topk(_t(scores), thr, k)
        want = jtopk.threshold_topk(jnp.asarray(scores), thr, k)
        for g, w in zip(got, want):
            _eq(g, w)


# ---------------------------------------------------------------------------
# fixed-radius NNS: both plans on the reference's edge cases
# ---------------------------------------------------------------------------
def _scenario(name, words):
    """-> (queries, db, radius, n_valid): `tests/test_nns_scale_matrix.py`'s
    cases, at the paper's 256-bit signatures."""
    rng = np.random.default_rng(17)

    def sigs(n):
        return rng.integers(0, 2**32, size=(n, words), dtype=np.uint32)

    if name == "n_valid_zero":
        db = sigs(96)
        return db[:4], db, 15 * words, 0
    if name == "non_aligned_n":
        db = sigs(300)
        return db[:5], db, 14 * words, 211
    if name == "duplicate_signatures":
        db = np.tile(sigs(5), (8, 1))
        return db[:3], db, 20 * words, None
    if name == "radius_overflow":
        db = sigs(200)
        return db[:4], db, 32 * words, None
    raise AssertionError(name)


SCENARIOS = ("n_valid_zero", "non_aligned_n", "duplicate_signatures",
             "radius_overflow")


def _both(q, db, radius, k, **kw):
    jkw = {a: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for a, v in kw.items()}
    tkw = {a: (_t(v) if isinstance(v, np.ndarray) else v)
           for a, v in kw.items()}
    want = _jit_nns(jnp.asarray(q), jnp.asarray(db), radius, k, **jkw)
    got = tnns.fixed_radius_nns(_t(q), _t(db), radius, k, **tkw)
    return got, want


def _assert_nns_equal(got, want):
    for f in ("indices", "distances", "counts"):
        _eq(getattr(got, f), getattr(want, f))
    assert (got.blocks_touched is None) == (want.blocks_touched is None)
    if got.blocks_touched is not None:
        _eq(got.blocks_touched, want.blocks_touched)


@pytest.mark.parametrize("plan,scenario", [
    *[(p, s) for p in ("dense", "streaming") for s in SCENARIOS],
    ("superblock", "non_aligned_n"), ("superblock", "radius_overflow")])
def test_fixed_radius_nns_matches_reference(plan, scenario):
    q, db, radius, n_valid = _scenario(scenario, 8)
    kw = {"n_valid": n_valid, "scan_block": 0 if plan == "dense" else 24}
    if plan == "superblock":  # several superblocks: the stable merge runs
        kw["superblock"] = 128
    got, want = _both(q, db, radius, 16, **kw)
    _assert_nns_equal(got, want)


def test_dense_plan_with_tombstone_mask():
    rng = np.random.default_rng(8)
    db = rng.integers(0, 2**32, size=(150, 8), dtype=np.uint32)
    mask = rng.random(150) < 0.7
    got, want = _both(db[:6], db, 120, 20, db_mask=mask, scan_block=0)
    _assert_nns_equal(got, want)


def _clustered(rng, n_blocks=6, br=128, words=8):
    centers = rng.integers(0, 2**32, size=(n_blocks, words), dtype=np.uint32)
    db = np.repeat(centers, br, axis=0)
    db ^= rng.integers(0, 2, size=db.shape, dtype=np.uint32) & \
        np.uint32(0x01010101)
    return centers[[0, 3, 3, 5]], db[: n_blocks * br - 40]


@pytest.mark.parametrize("masked", [False, True])
def test_block_summary_and_pruning_match_reference(masked):
    rng = np.random.default_rng(9)
    q, db = _clustered(rng)
    mask = (rng.random(db.shape[0]) < 0.8) if masked else None
    jsum = jnns.build_block_summary(db, 128, db_mask=mask, n_valid=700)
    tsum = tnns.build_block_summary(_t(db), 128, db_mask=mask, n_valid=700)
    for f in ("or_sigs", "and_sigs", "min_pc", "max_pc", "n_alive"):
        _eq(getattr(tsum, f), getattr(jsum, f))
    assert tsum.n_blocks == jsum.n_blocks and tsum.block_rows == 128
    _eq(tnns.summary_block_bounds(_t(q), tsum),
        jnns.summary_block_bounds(jnp.asarray(q), jsum))

    kw = {"db_mask": mask, "n_valid": 700, "scan_block": 64}
    plain, _ = _both(q, db, 40, 16, **kw)
    want = _jit_nns(
        jnp.asarray(q), jnp.asarray(db), 40, 16, summary=jsum,
        **{a: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for a, v in kw.items()})
    got = tnns.fixed_radius_nns(
        _t(q), _t(db), 40, 16, summary=tsum,
        **{a: (_t(v) if isinstance(v, np.ndarray) else v)
           for a, v in kw.items()})
    _assert_nns_equal(got, want)
    assert int(got.blocks_touched.min()) < tsum.n_blocks  # really pruned
    for f in ("indices", "distances", "counts"):  # sound: same bits
        _eq(getattr(got, f), getattr(plain, f))
    off = tnns.fixed_radius_nns(_t(q), _t(db), 40, 16, summary=tsum,
                                prune=False, scan_block=64, n_valid=700,
                                db_mask=None if mask is None else _t(mask))
    assert off.blocks_touched is None
    _eq(off.indices, plain.indices)


def test_plan_routing_mirrors_reference():
    for n in (0, 1000, tnns.STREAM_MIN_ITEMS - 1, tnns.STREAM_MIN_ITEMS):
        for sb in (None, 0, 128):
            assert tnns._plan_streams(n, sb) == jnns._plan_streams(n, sb)
    assert tnns.STREAM_MIN_ITEMS == jnns.STREAM_MIN_ITEMS
    assert tnns.SUMMARY_BLOCK_ROWS == jnns.SUMMARY_BLOCK_ROWS


# ---------------------------------------------------------------------------
# hot-row caches and the delta-aware row paths
# ---------------------------------------------------------------------------
def test_top_ids_by_freq_ties_and_eligibility():
    rng = np.random.default_rng(3)
    freqs = rng.integers(0, 5, 400)  # many ties
    elig = rng.random(400) < 0.6
    for k in (0, 7, 64, 400, 500):
        _eq(thot.top_ids_by_freq(freqs, k), jhot.top_ids_by_freq(freqs, k))
        _eq(thot.top_ids_by_freq(freqs, k, elig),
            jhot.top_ids_by_freq(freqs, k, elig))


@pytest.mark.parametrize("capacity,with_freqs", [(0, False), (1, True),
                                                 (32, True), (32, False)])
def test_hot_cache_rows_and_counters(capacity, with_freqs):
    rng = np.random.default_rng(capacity)
    jq, tq = _qt_pair(rng, 90, 32)
    freqs = rng.integers(0, 50, 90) if with_freqs else None
    jc = jhot.build_hot_cache(jq, freqs, capacity)
    tc = thot.build_hot_cache(tq, freqs, capacity)
    _eq(tc.hot_ids, jc.hot_ids)
    _eq(tc.hot_rows, jc.hot_rows)
    ids = rng.integers(-1, 90, size=(7, 20)).astype(np.int32)
    got_rows, got_st = thot.cached_rows(tc, tq, _t(ids))
    want_rows, want_st = _jit_cached_rows(jc, jq, jnp.asarray(ids))
    _eq(got_rows, want_rows)
    assert got_st.as_dict() == want_st.as_dict()
    got_bag, got_st = thot.cached_embedding_bag(tc, tq, _t(ids), mode="mean")
    want_bag, want_st = jax.jit(functools.partial(
        jhot.cached_embedding_bag, mode="mean"))(jc, jq, jnp.asarray(ids))
    np.testing.assert_allclose(got_bag.numpy(), np.asarray(want_bag),
                               rtol=FLOAT_RTOL, atol=1e-8)
    assert got_st.as_dict() == want_st.as_dict()


def test_probe_over_invalid_id_padded_cache():
    """A cache with INVALID_ID-padded slots (as `pin_rows` makes them):
    the searchsorted probe and clip never report a padding slot as hit."""
    rng = np.random.default_rng(6)
    jq, tq = _qt_pair(rng, 50, 32)
    jc = jhot.pin_rows(jq, np.array([3, 9, 49], np.int32), 8)
    assert int(np.asarray(jc.hot_ids)[-1]) == thot.INVALID_ID
    tc = thot.HotRowCache(hot_ids=_t(jc.hot_ids), hot_rows=_t(jc.hot_rows),
                          capacity=8)
    ids = np.array([[3, 9, 49, 0, -1, 48, 9]], np.int32)
    got, st = thot.cached_rows(tc, tq, _t(ids))
    want, wst = _jit_cached_rows(jc, jq, jnp.asarray(ids))
    _eq(got, want)
    assert st.as_dict() == wst.as_dict() == {"hits": 4, "lookups": 6,
                                             "hit_rate": 4 / 6}


# ---------------------------------------------------------------------------
# the plain grouped pool (`kernels/ref.py:grouped_pool_ref`) against the
# reference's cached bags, cached rows and uncached bags
# ---------------------------------------------------------------------------
def _pool_mag(segs, ids, outs_shape, valid, weights):
    """Per output element, the sum of its terms' magnitudes: the plain
    grouped pool over |values| and |weights|."""
    abs_segs = [tref.PoolSegment(
        values=seg.values.abs(), scales=seg.scales, mode=seg.mode,
        column=seg.column,
        hot_ids=None if seg.hot_ids is None else seg.hot_ids,
        hot_rows=None if seg.hot_rows is None else seg.hot_rows.abs(),
        masked=seg.masked) for seg in segs]
    outs = [torch.zeros(shape) for shape in outs_shape]
    tref.grouped_pool_ref(abs_segs, ids, outs, valid,
                          None if weights is None else
                          [None if w is None else w.abs() for w in weights])
    return outs


def _hot_pair(jq, tq, rng, kind):
    """(reference cache, port cache) of one kind: none, empty, a hot set
    pinned by frequency, or a pinned set padded with INVALID_ID slots."""
    n = tq.values.shape[0]
    if kind == "none":
        return None, None
    if kind == "sentinel":
        jc = jhot.pin_rows(jq, rng.choice(n, 5, replace=False), 9)
    else:
        jc = jhot.build_hot_cache(jq, rng.integers(0, 50, n),
                                  0 if kind == "empty" else 16)
    return jc, thot.HotRowCache(hot_ids=_t(jc.hot_ids),
                                hot_rows=_t(jc.hot_rows),
                                capacity=jc.capacity)


def _pool_ids(rng, n, B, L):
    """-1 padding, ids past the table, a bag with every slot padded, and
    (where the cache holds sentinels) the sentinel id itself."""
    ids = rng.integers(-1, n + 3, size=(B, L)).astype(np.int32)
    ids[1] = -1
    ids[2, 0] = thot.INVALID_ID
    return ids


def _reference_segment(mode, jc, jq, ids, w):
    """The reference's own function for one segment -> (out, stats)."""
    if mode == "rows":
        return _jit_cached_rows(jc, jq, ids)
    if jc is None:
        return jemb.embedding_bag(jq, ids, w, mode=mode), None
    return jax.jit(functools.partial(jhot.cached_embedding_bag, mode=mode))(
        jc, jq, ids, w)


@pytest.mark.parametrize("mode,cache,weighted", [
    ("sum", "none", False), ("sum", "hot", True), ("sum", "sentinel", False),
    ("mean", "hot", False), ("mean", "empty", True), ("mean", "sentinel",
                                                      False),
    ("rows", "hot", False), ("rows", "sentinel", False), ("rows", "empty",
                                                          False)])
def test_grouped_pool_segment_matches_reference(mode, cache, weighted):
    rng = np.random.default_rng(len(mode) * 7 + len(cache) + weighted)
    n, d, B, L = 70, 32, 9, 20
    jq, tq = _qt_pair(rng, n, d)
    jc, tc = _hot_pair(jq, tq, rng, cache)
    ids = _pool_ids(rng, n, B, L)
    valid = np.arange(B) != 4  # a padding row of the batch
    w = rng.normal(size=(B, L)).astype(np.float32) if weighted else None
    seg = tref.PoolSegment(
        values=tq.values, scales=tq.scales, mode=mode, column=3,
        hot_ids=None if tc is None else tc.hot_ids,
        hot_rows=None if tc is None else tc.hot_rows, counted=True)
    shape = (B, L, d + 5) if mode == "rows" else (B, d + 5)
    out = torch.full(shape, 7.0)
    tw = None if w is None else [_t(w)]
    counts = tref.grouped_pool_ref([seg], [_t(ids)], [out], _t(valid), tw)

    masked = jnp.where(jnp.asarray(valid)[:, None], jnp.asarray(ids), -1)
    want, wst = _reference_segment(mode, jc, jq, masked,
                                   None if w is None else jnp.asarray(w))
    want = np.asarray(want)
    got = out[..., 3:3 + d].numpy()
    assert (out[..., :3] == 7.0).all() and (out[..., 3 + d:] == 7.0).all()
    if mode == "rows":  # one IEEE product an element: equal
        _eq(got, want)
    else:
        mag = _pool_mag([seg], [_t(ids)], [shape], _t(valid), tw)[0]
        np.testing.assert_array_less(
            np.abs(got - want), FLOAT_RTOL * mag[..., 3:3 + d].numpy()
            + 1e-12)
        _eq(got[1], np.zeros(d))  # every slot padded: zeros, also in mean
    _eq(got[4], np.zeros_like(got[4]))  # the batch's padding row
    if wst is None:  # the uncached bag has no counters; the hits are 0
        wst = jhot.CacheStats(hits=jnp.int32(0), lookups=jnp.int32(
            int((np.asarray(masked) >= 0).sum())))
    assert {"hits": int(counts[0]), "lookups": int(counts[1])} == \
        {"hits": int(wst.hits), "lookups": int(wst.lookups)}
    if cache == "hot":
        assert int(counts[0]) > 0  # the case really hits


@pytest.mark.parametrize("stage", ["lookup", "rank"])
def test_grouped_pool_stage_matches_reference(stage):
    """A stage's whole segment list in one call: the lookup stage's five
    one-slot feature bags and the mean history bag side by side in one
    buffer, or the rank stage's candidate rows after a context gap plus
    the genre bag (unmasked, uncounted) in its own buffer."""
    rng = np.random.default_rng(len(stage))
    B, d = 11, 32
    valid = np.arange(B) < B - 2
    jvalid = jnp.asarray(valid)[:, None]
    tabs = [_qt_pair(rng, n, d) for n in (40, 9, 30, 60, 25, 90)]
    if stage == "lookup":
        caches = [_hot_pair(jq, tq, rng, kind) for (jq, tq), kind in zip(
            tabs, ("hot", "empty", "sentinel", "hot", "hot", "hot"))]
        ids = [rng.integers(-1, tq.values.shape[0] + 2, size=(B, 1))
               .astype(np.int32) for _, tq in tabs[:5]]
        ids.append(_pool_ids(rng, 90, B, 20))
        modes = ["sum"] * 5 + ["mean"]
        segs = [tref.PoolSegment(
            values=tq.values, scales=tq.scales, mode=m, column=i * d,
            hot_ids=None if tc is None else tc.hot_ids,
            hot_rows=None if tc is None else tc.hot_rows, counted=True)
            for i, ((_, tq), (_, tc), m) in enumerate(zip(tabs, caches,
                                                          modes))]
        out = torch.zeros((B, 6 * d))
        outs, views = [out] * 6, [out[:, i * d:(i + 1) * d]
                                  for i in range(6)]
    else:
        (jq_i, tq_i), (jq_g, tq_g) = tabs[5], tabs[1]
        jc, tc = _hot_pair(jq_i, tq_i, rng, "hot")
        caches = [(jc, tc), (None, None)]
        ids = [_pool_ids(rng, 90, B, 50),
               rng.integers(0, 9, size=(B, 1)).astype(np.int32)]
        segs = [tref.PoolSegment(values=tq_i.values, scales=tq_i.scales,
                                 mode="rows", column=96, hot_ids=tc.hot_ids,
                                 hot_rows=tc.hot_rows, counted=True),
                tref.PoolSegment(values=tq_g.values, scales=tq_g.scales,
                                 masked=False)]
        modes = ["rows", "sum"]
        outs = [torch.zeros((B, 50, 96 + d)), torch.zeros((B, d))]
        views = [outs[0][..., 96:], outs[1]]
        tabs = [tabs[5], tabs[1]]
    counts = tref.grouped_pool_ref(segs, [_t(x) for x in ids], outs,
                                   _t(valid))
    hits = lookups = 0
    for seg, (jq, _), (jc, _), x, m, view in zip(segs, tabs, caches, ids,
                                                 modes, views):
        jx = jnp.where(jvalid, jnp.asarray(x), -1) if seg.masked else \
            jnp.asarray(x)
        want, wst = _reference_segment(m, jc, jq, jx, None)
        np.testing.assert_allclose(view.numpy(), np.asarray(want),
                                   rtol=FLOAT_RTOL, atol=1e-8)
        if seg.counted:
            hits, lookups = hits + int(wst.hits), lookups + int(wst.lookups)
    assert (int(counts[0]), int(counts[1])) == (hits, lookups)
    assert hits > 0


def test_delta_rows_match_reference():
    rng = np.random.default_rng(12)
    jq, tq = _qt_pair(rng, 40, 32)
    jd = jcat.empty_delta(6, 32, 8)
    ids = np.array([2, 17, 45, jcat.EMPTY_ID, jcat.EMPTY_ID,
                    jcat.EMPTY_ID], np.int32)
    vals = rng.integers(-127, 128, size=(6, 32)).astype(np.int8)
    scales = rng.random((6, 1)).astype(np.float32)
    jd = jcat.DeltaShard(ids=jnp.asarray(ids), values=jnp.asarray(vals),
                         scales=jnp.asarray(scales), sigs=jd.sigs,
                         capacity=6)

    class Delta:  # the port's frozen engine never holds one
        pass

    td = Delta()
    td.ids, td.values, td.scales, td.capacity = (_t(ids), _t(vals),
                                                 _t(scales), 6)
    probe = np.array([[2, 3, 45, -1, 17, 44]], np.int32)
    for g, w in zip(tcat.delta_rows(td, _t(probe)),
                    _jit_delta_rows(jd, jnp.asarray(probe))):
        _eq(g, w)
    cache_j = jhot.build_hot_cache(jq, None, 4)
    cache_t = thot.build_hot_cache(tq, None, 4)
    for delta_j, delta_t in ((None, None), (jd, td)):
        g, gs = tcat.delta_cached_rows(delta_t, cache_t, tq, _t(probe))
        w, ws = _jit_delta_cached_rows(delta_j, cache_j, jq,
                                       jnp.asarray(probe))
        _eq(g, w)
        assert gs.as_dict() == ws.as_dict()


def test_mlp_apply_matches_reference():
    rng = np.random.default_rng(0)
    dims = (192, 128, 64, 32)
    layers = [{"w": rng.standard_normal((a, b)).astype(np.float32) * a**-.5,
               "b": rng.standard_normal(b).astype(np.float32)}
              for a, b in zip(dims[:-1], dims[1:])]
    x = rng.standard_normal((11, 192)).astype(np.float32)
    for final_act in (False, True):
        got = trs._mlp_apply([{k: _t(v) for k, v in p.items()}
                              for p in layers], _t(x), final_act)
        want = jrs._mlp_apply([{k: jnp.asarray(v) for k, v in p.items()}
                               for p in layers], jnp.asarray(x), final_act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FLOAT_RTOL, atol=1e-6)
    assert trs.default_youtubednn_config() == \
        trs.YoutubeDNNConfig(**{**jrs.default_youtubednn_config()._asdict()})
