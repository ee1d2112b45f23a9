"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports neither JAX nor the reference package, so it also runs
where only PyTorch is installed; from the repository root:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` because `tests/conftest.py` imports JAX.) The plain
versions are themselves held against the JAX reference on the CPU by
`tests/test_torch_kernels.py`, `tests/test_torch_core.py` and
`tests/test_torch_engine.py`. The serving front-ends must serve the same
bits in every mode on the card, and the pipelined ring must queue a
bucket without a host sync. The multi-GPU plans run over a world-size-1
NCCL group, and the sharded scan as banks on one card. Integer outputs
must be equal; the pool's floats are held to 1e-6 of the pooled
magnitudes, as there. The flash
kernel is held to 2e-5 in float32 and 2e-2 in bfloat16 (the Pallas
kernel's tolerances in `tests/test_kernels.py`; both sides accumulate in
float32 in another order), the int8 matmul bit for bit. The LM train step (reduced qwen3-8b) and the blocked
attention's custom backward are held against their CPU runs.
"""
import contextlib
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.nns import (
    _prune_mask,
    build_block_summary,
    fixed_radius_nns,
)
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import training
from repro_torch.kernels import build, ops, ref
from repro_torch.data import synthetic
from repro_torch.models import attention as tattn
from repro_torch.models.recsys import default_youtubednn_config
from repro_torch.serving import (
    LiveCatalog,
    OnlineTrainer,
    ShadowHarness,
    make_server,
    rebuild_from_params,
)
from repro_torch.serving import recsys_engine as trs
from repro_torch.utils import tree_leaves, tree_map

pytestmark = pytest.mark.cuda
POOL_RTOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _sigs(rng, n, words, device):
    a = rng.integers(0, 2**32, size=(n, words), dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


@contextlib.contextmanager
def _plain(*ops_names):
    keys = [f"REPRO_TORCH_{n.upper()}" for n in ops_names]
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "torch" for k in keys})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("q,n,words", [(256, 3000, 8), (7, 1029, 8),
                                       (5, 300, 2), (3, 100, 3), (9, 33, 1)])
def test_hamming_equals_plain(cuda, q, n, words):
    rng = np.random.default_rng(n)
    queries, db = _sigs(rng, q, words, cuda), _sigs(rng, n, words, cuda)
    before = build.HAMMING.launches
    got = ops.hamming_distances(queries, db)
    torch.cuda.synchronize()
    assert build.HAMMING.launches == before + 1
    assert torch.equal(got, ref.hamming_distance_ref(queries, db))


def _plain_hamming(queries, db, chunk=1 << 15):
    return torch.cat([ref.hamming_distance_ref(queries, db[i:i + chunk])
                      for i in range(0, db.shape[0], chunk)], dim=1)


@pytest.mark.parametrize("q", [1, 17, 256])
@pytest.mark.parametrize("n", [1, 7, 3000, 262143])
@pytest.mark.parametrize("words", [1, 3, 5, 8])
def test_hamming_tensor_core_shapes_equal_plain(cuda, q, n, words):
    """The tensor-core Hamming kernel around its 64 x 64 tile: one query
    to phase A's 256, one row to the largest dense catalog. For n odd the
    kernel writes rows padded to a multiple of 4 and the op returns the
    (q, n) view of them, with that row stride."""
    rng = np.random.default_rng(q + n + words)
    queries, db = _sigs(rng, q, words, cuda), _sigs(rng, n, words, cuda)
    before = build.HAMMING.launches
    got = ops.hamming_distances(queries, db)
    torch.cuda.synchronize()
    assert build.HAMMING.launches == before + 1
    assert got.shape == (q, n) and got.stride() == (-(-n // 4) * 4, 1)
    assert torch.equal(got, _plain_hamming(queries, db))


def _pool_table(rng, n, d, device):
    values = torch.from_numpy(
        rng.integers(-127, 128, size=(n, d)).astype(np.int8)).to(device)
    scales = torch.from_numpy(
        (rng.random((n, 1)) * 0.01 + 1e-4).astype(np.float32)).to(device)
    return values, scales


def _pinned(values, scales, ids, capacity):
    """A hot set pinning `ids` (ascending), INVALID_ID-padded to
    `capacity` with zero rows, as the reference's `pin_rows` makes it."""
    from repro_torch.serving.hot_cache import INVALID_ID

    ids = torch.sort(ids.to(torch.int32)).values
    hot = torch.full((capacity,), INVALID_ID, dtype=torch.int32,
                     device=values.device)
    rows = torch.zeros((capacity, values.shape[1]), device=values.device)
    hot[:ids.shape[0]] = ids
    rows[:ids.shape[0]] = values[ids.long()].float() * scales[ids.long()]
    return hot, rows


def _pool_both(plan, ids, outs, valid, weights=None):
    """The grouped kernel (one launch) and the plain version on the same
    inputs -> (kernel outs, counts), (plain outs, counts)."""
    got = [o.clone() for o in outs]
    before = build.EMBEDDING_POOL.launches
    counts = ops.grouped_pool(plan, ids, got, valid, weights)
    torch.cuda.synchronize()
    assert build.EMBEDDING_POOL.launches == before + 1
    want = [o.clone() for o in outs]
    with _plain("embedding_pool"):
        want_counts = ops.grouped_pool(plan, ids, want, valid, weights)
    assert build.EMBEDDING_POOL.launches == before + 1
    return (got, counts), (want, want_counts)


@pytest.mark.parametrize("d,L,weighted,hot", [
    (32, 20, True, "sentinel"), (40, 1, False, "none"),
    (160, 45, True, "pinned"), (32, 0, False, "pinned"),
    (8, 33, False, "sentinel"), (32, 20, False, "large")])
def test_grouped_pool_segments_equal_plain(cuda, d, L, weighted, hot):
    """Sum, mean and rows segments of one table in one launch, bit for bit
    and with equal counters: weights, d off and past 128 columns (two
    passes), L past one 32-slot chunk and L = 0, ids past the table,
    padding ids and rows, hot sets with INVALID_ID sentinels (the
    sentinel id itself hits a zero row), and a hot set too large for
    shared memory (searched in device memory)."""
    from repro_torch.serving.hot_cache import INVALID_ID

    rng = np.random.default_rng(d + L)
    n, B = (3000, 37) if hot == "large" else (300, 37)
    values, scales = _pool_table(rng, n, d, cuda)
    hot_ids = hot_rows = None
    if hot != "none":
        k = 2100 if hot == "large" else 20
        pick = torch.from_numpy(rng.choice(n, k, replace=False)).to(cuda)
        hot_ids, hot_rows = _pinned(values, scales, pick,
                                    k + 12 if hot == "sentinel" else k)
    ids = rng.integers(-1, n + 4, size=(B, L)).astype(np.int32)
    if L:
        ids[0, 0] = INVALID_ID
        ids[3] = -1  # a bag with every slot padded
    ids = torch.from_numpy(ids).to(cuda)
    w = (torch.from_numpy(rng.normal(size=(B, L)).astype(np.float32))
         .to(cuda) if weighted else None)
    valid = torch.from_numpy(np.arange(B) % 5 != 2).to(cuda)
    segs = [ops.PoolSegment(values, scales, mode=m, column=c,
                            hot_ids=hot_ids, hot_rows=hot_rows, counted=cnt,
                            masked=msk)
            for m, c, cnt, msk in (("sum", 0, True, True),
                                   ("mean", d + 3, True, False),
                                   ("rows", 5, False, True))]
    plan = ops.PoolPlan(segs)
    outs = [torch.full((B, 2 * d + 3), 9.0, device=cuda)] * 2 + [
        torch.full((B, L, d + 5), 9.0, device=cuda)]
    (got, counts), (want, want_counts) = _pool_both(
        plan, [ids] * 3, outs, valid, [w, w, None])
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)
    assert torch.equal(counts, want_counts)
    assert int(counts[1]) == 2 * int((ids >= 0).sum()) - int(
        (ids[~valid] >= 0).sum())


@pytest.mark.parametrize("with_valid", [False, True])
def test_grouped_pool_stages_equal_plain(cuda, with_valid):
    """The engine's two stages, each one launch: the lookup stage's six
    segments and the rank stage's candidate rows + genre bag, bit for bit
    with the plain version, CacheStats included."""
    cfg = default_youtubednn_config()._replace(n_items=2000)
    rng = np.random.default_rng(1)
    eng = trs.RecSysEngine.build(
        _numpy_params(cfg, rng), cfg,
        lsh_proj=torch.from_numpy(rng.standard_normal((32, 256))
                                  .astype(np.float32)),
        hot_rows=64, item_freqs=rng.integers(0, 100, cfg.n_items),
        device=cuda)
    B = 96
    raw = {k: rng.integers(0, c, B).astype(np.int32)
           for k, c in cfg.user_features.items()}
    raw.update(history=rng.integers(-1, cfg.n_items + 2, (B, 20))
               .astype(np.int32), genre=rng.integers(0, 18, B)
               .astype(np.int32))
    if with_valid:
        raw["valid"] = np.arange(B) < B - 7
    batch = eng.batch_to_device(raw)
    valid = batch.get("valid")
    names = sorted(cfg.user_features)
    x = torch.zeros((B, eng.lookup_plan.width), device=cuda)
    ids = [batch[k][:, None] for k in names] + [batch["history"]]
    (got, c), (want, wc) = _pool_both(eng.lookup_plan, ids, [x] * 6, valid)
    assert torch.equal(got[0], want[0]) and torch.equal(c, wc)
    cand = torch.from_numpy(rng.integers(-1, cfg.n_items, (B, 50))
                            .astype(np.int32)).to(cuda)
    outs = [torch.zeros((B, 50, eng.rank_plan.width), device=cuda),
            torch.zeros((B, 32), device=cuda)]
    (got, c), (want, wc) = _pool_both(
        eng.rank_plan, [cand, batch["genre"][:, None]], outs, valid)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(c, wc) and int(c[0]) > 0


@pytest.mark.parametrize("n,d,B,L,weighted", [
    (18, 32, 256, 1, False), (3000, 32, 256, 20, True),
    (300, 64, 37, 20, False), (50, 40, 5, 3, True)])
def test_embedding_pool_equals_plain(cuda, n, d, B, L, weighted):
    rng = np.random.default_rng(n + L)
    values = torch.from_numpy(
        rng.integers(-127, 128, size=(n, d)).astype(np.int8)).to(cuda)
    scales = torch.from_numpy(
        (rng.random((n, 1)) * 0.01 + 1e-4).astype(np.float32)).to(cuda)
    ids = rng.integers(-1, n, size=(B, L)).astype(np.int32)
    ids[0] = -1  # an all-padding bag
    ids = torch.from_numpy(ids).to(cuda)
    w = (torch.from_numpy(rng.normal(size=(B, L)).astype(np.float32))
         .to(cuda) if weighted else None)
    got = ops.embedding_pool(values, scales, ids, w)
    want = ref.embedding_pool_ref(values, scales, ids, w)
    mag = ref.embedding_pool_ref(values.abs(), scales, ids,
                                 None if w is None else w.abs())
    assert bool(((got - want).abs() <= POOL_RTOL * mag + 1e-12).all())
    assert bool((got[0] == 0).all())
    if L == 1 and w is None:  # one term per output: exactly the plain one
        assert torch.equal(got, want)


def _clustered(rng, n, q, words, device, br=128):
    centers = rng.integers(0, 2**32, size=(n // br + 1, words),
                           dtype=np.uint32)
    db = np.repeat(centers, br, axis=0)[:n].copy()
    db ^= rng.integers(0, 2, size=db.shape, dtype=np.uint32) & \
        np.uint32(0x00010001)
    queries = centers[rng.integers(0, centers.shape[0], q)]
    return (torch.from_numpy(queries.view(np.int32)).to(device),
            torch.from_numpy(db.view(np.int32)).to(device))


# (words, queries, rows, radius): query counts around the kernel's
# 128-query tile, row counts off its 64-row tile, radius 0 and radius at or
# above 32 words (every row matches)
STREAM_SHAPES = [(8, 37, 9000, 40), (1, 130, 5000, 5), (3, 257, 7001, 20),
                 (5, 37, 3333, 0), (8, 130, 9000, 256), (3, 37, 2000, 200)]


@pytest.mark.parametrize("masked,pruned,superblock", [
    (False, False, None), (True, False, None), (False, True, None),
    (True, True, None), (False, False, 2048), (True, True, 256)])
@pytest.mark.parametrize("k", [1, 50, 128])
@pytest.mark.parametrize("words,nq,n,radius", STREAM_SHAPES)
def test_streaming_nns_equals_plain(cuda, masked, pruned, superblock, k,
                                    words, nq, n, radius):
    rng = np.random.default_rng(11)
    queries, db = _clustered(rng, n, nq, words, cuda)
    kw = {}
    if masked:
        kw["db_mask"] = torch.rand(db.shape[0], device=cuda) < 0.8
    if pruned:  # sound masks that differ between the queries of a tile
        summary = build_block_summary(db, 128, db_mask=kw.get("db_mask"))
        kw["prune_blocks"], _ = _prune_mask(queries, summary, radius)
        kw["prune_block_rows"] = 128
        if radius < 16 * words:
            assert bool(kw["prune_blocks"].any())
    before = build.STREAMING_NNS.launches
    got = ops.streaming_nns(queries, db, radius=radius, max_candidates=k,
                            n_valid=n - 100, superblock=superblock, **kw)
    torch.cuda.synchronize()
    assert build.STREAMING_NNS.launches == before + 1
    want = ref.streaming_nns_ref(queries, db, radius, k, n_valid=n - 100,
                                 superblock=superblock, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].sum()) > 0


@pytest.mark.parametrize("case", ["n_valid_zero", "duplicates",
                                  "radius_overflow", "empty_db",
                                  "radius_zero", "radius_negative",
                                  "ragged_queries", "one_word"])
def test_streaming_nns_edge_cases_equal_dense_plan(cuda, case):
    rng = np.random.default_rng(5)
    db = _sigs(rng, 700, 8, cuda)
    radius, n_valid, queries = 110, None, db[:6]
    if case == "n_valid_zero":
        n_valid = 0
    elif case == "duplicates":
        db = db[:7].repeat(100, 1)
        queries = db[:4]
    elif case == "radius_overflow":
        radius = 256
    elif case == "radius_zero":
        db = db[:7].repeat(100, 1)
        queries, radius = db[:4], 0
    elif case == "radius_negative":
        radius = -1
    elif case == "ragged_queries":
        queries = db[:130]
    elif case == "one_word":
        db = db[:, :1].contiguous()
        queries, radius = db[:200], 6
    else:
        db = db[:0]
    stream = fixed_radius_nns(queries, db, radius, 50, scan_block=4096,
                              n_valid=n_valid)
    with _plain("hamming_distances"):
        dense = fixed_radius_nns(queries, db, radius, 50, scan_block=0,
                                 n_valid=n_valid)
    for f in ("indices", "distances", "counts"):
        assert torch.equal(getattr(stream, f), getattr(dense, f))


def test_kernels_refuse_bad_input(cuda):
    x = torch.zeros((4, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        ops.hamming_distances(x, x)
    q = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ops.streaming_nns(q, q, radius=3, max_candidates=129)
    with pytest.raises(ValueError):
        ops.streaming_nns(q, q.cpu(), radius=3, max_candidates=4)
    plan = ops.PoolPlan([ops.PoolSegment(
        torch.zeros((5, 32), dtype=torch.int8, device=cuda),
        torch.ones((5, 1), device=cuda))])
    ids = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    out = torch.zeros((4, 32), device=cuda)
    for bad_ids, bad_out in ((ids.long(), out), (ids, out.cpu()),
                             (ids, out[:3]), (ids, out[:, :31]),
                             (ids, out.t())):
        with pytest.raises(ValueError):
            ops.grouped_pool(plan, [bad_ids], [bad_out])
    with pytest.raises(ValueError):  # one batch row too many in valid
        ops.grouped_pool(plan, [ids], [out],
                         valid=torch.ones(5, dtype=torch.bool, device=cuda))


def _numpy_params(cfg, rng):
    d = cfg.embed_dim

    def mlp(dims):
        return [{"w": (rng.standard_normal((a, b)) * a**-0.5)
                 .astype(np.float32), "b": np.zeros(b, np.float32)}
                for a, b in zip(dims[:-1], dims[1:])]

    return {"tables": {k: (0.05 * rng.standard_normal((c, d)))
                       .astype(np.float32)
                       for k, c in sorted(cfg.user_features.items())},
            "item_table": (0.05 * rng.standard_normal((cfg.n_items, d)))
            .astype(np.float32),
            "genre_table": (0.05 * rng.standard_normal((18, d)))
            .astype(np.float32),
            "filter_mlp": mlp((6 * d, 128, 64, 32)),
            "rank_mlp": mlp((4 * d, 128, 1))}


@pytest.mark.parametrize("scan_block", [None, 128])
def test_engine_on_the_card_serves_like_the_cpu_engine(cuda, scan_block):
    cfg = default_youtubednn_config()._replace(n_items=2000)
    rng = np.random.default_rng(0)
    params = _numpy_params(cfg, rng)
    proj = torch.from_numpy(rng.standard_normal((32, 256))
                            .astype(np.float32))
    engines = {dev: trs.RecSysEngine.build(
        params, cfg, lsh_proj=proj, hot_rows=64, scan_block=scan_block,
        device=dev) for dev in ("cpu", "cuda")}
    batch = {k: rng.integers(0, c, 64).astype(np.int32)
             for k, c in cfg.user_features.items()}
    hist = rng.integers(-1, cfg.n_items, (64, 20)).astype(np.int32)
    batch.update(history=hist, genre=rng.integers(0, 18, 64)
                 .astype(np.int32), valid=np.arange(64) < 60)
    cpu, gpu = engines["cpu"], engines["cuda"]
    sigs = trs.lsh_signature(cpu.user_embedding(batch), cpu.lsh_proj)
    a, b = trs._nns(cpu, sigs), trs._nns(gpu, sigs.to(cuda))
    for f in ("indices", "distances", "counts"):
        assert torch.equal(getattr(a, f), getattr(b, f).cpu())
    build.reset_launches()
    got = gpu.serve(batch)
    counts = build.launch_counts()
    assert counts["embedding_pool"] == 2  # one grouped launch a stage
    assert counts["hamming_distances" if scan_block is None
                  else "streaming_nns"] == 1
    with _plain("hamming_distances", "embedding_pool", "streaming_nns"):
        plain = gpu.serve(batch)
    assert build.launch_counts() == counts  # the plain path launched none
    assert torch.equal(got.items, plain.items)
    assert torch.equal(got.nns.indices, plain.nns.indices)
    assert got.stats.as_dict() == cpu.serve(batch).stats.as_dict()


# ---------------------------------------------------------------------------
# the serving front-ends on the card
# ---------------------------------------------------------------------------
SERVE_BATCH = 64


def _serving_setup(device, scan_block):
    """A 2000-item engine on `device` (dense plan for scan_block None, the
    pruned streaming plan for 128) and 150 single-user queries: two full
    64-query buckets and a 22-query tail."""
    cfg = default_youtubednn_config()._replace(n_items=2000)
    rng = np.random.default_rng(1)
    params = _numpy_params(cfg, rng)
    proj = torch.from_numpy(rng.standard_normal((32, 256))
                            .astype(np.float32))
    eng = trs.RecSysEngine.build(params, cfg, lsh_proj=proj, hot_rows=64,
                                 scan_block=scan_block, device=device)
    data = synthetic.make_movielens(n_users=300, n_items=cfg.n_items)
    return eng, synthetic.serving_queries(data, np.arange(150))


def _served_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.status == "ok"
        np.testing.assert_array_equal(g.items, w.items)
        np.testing.assert_array_equal(g.scores, w.scores)


def _served_close(got, want):
    """Served in buckets of another row count: cuBLAS picks its GEMM (and
    its split of the sum) by shape, so CTRs may differ in the last bits;
    within 1e-6, and ids equal wherever the CTR gaps exceed 2e-6."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.status == "ok"
        np.testing.assert_allclose(g.scores, w.scores, rtol=1e-6, atol=1e-7)
        s = np.where(np.isfinite(w.scores), w.scores, -1.0)
        k = int(np.cumprod(s[:-1] - s[1:] > 2e-6).sum())
        np.testing.assert_array_equal(g.items[:k], w.items[:k])


@pytest.mark.parametrize("scan_block", [None, 128])
def test_pipelined_dispatch_never_waits_on_the_host(cuda, scan_block):
    """Staging, the three stages and the queued device-to-host copies of a
    bucket run under `set_sync_debug_mode("error")`: no hidden host sync
    on the dispatch path; only retiring a bucket waits."""
    eng, queries = _serving_setup(cuda, scan_block)
    want = make_server(eng, "sync", max_batch=SERVE_BATCH).serve_many(
        queries)
    server = make_server(eng, "pipelined", max_batch=SERVE_BATCH, depth=2)
    server.serve_many(queries[:SERVE_BATCH])  # warm-up: cuBLAS, allocators
    dispatch, n = server._dispatch, []

    def checked(parts):
        n.append(len(parts))
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(parts)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    server._dispatch = checked
    _served_equal(server.serve_many(queries), want)
    assert len(n) == 3
    assert server.stats()["n_errors"] == 0
    # the mode does see the sync the staging avoids: a pageable copy
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.from_numpy(np.arange(16, dtype=np.int32)).to(cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("scan_block", [None, 128])
def test_server_modes_bit_equal_on_the_card(cuda, scan_block):
    """Sync, pipelined and concurrent serving (its queue staged before the
    drain starts, so its buckets are sync's) give the same items, scores
    and cache counters; coalesced serving (two 64-query buckets as one
    128-row batch) the same ids and CTRs within 1e-6 (`_served_close`).
    Each dispatch launches the pool twice and the scan's kernel once."""
    eng, queries = _serving_setup(cuda, scan_block)
    scan = "hamming_distances" if scan_block is None else "streaming_nns"
    stats = {}
    results = {}
    # mode, knobs, dispatches for 150 queries: 64, 64 and a 22-query tail
    for mode, knobs, dispatches in (
            ("sync", {}, 3), ("pipelined", {"depth": 2}, 3),
            ("pipelined", {"depth": 3, "coalesce": 2}, 2),
            ("concurrent", {"tenants": 2, "depth": 2, "autostart": False},
             3)):
        server = make_server(eng, mode, max_batch=SERVE_BATCH, **knobs)
        build.reset_launches()
        results[mode, str(knobs)] = server.serve_many(queries)
        torch.cuda.synchronize()
        launches = build.launch_counts()
        st = server.stats()
        server.close()
        assert st["n_errors"] == 0 and st["last_error"] is None
        assert st["n_served"] == len(queries) and st["n_batches"] == 3
        stats[mode, str(knobs)] = {k: st[k] for k in (
            "n_served", "cache_hits", "cache_lookups")}
        assert launches["embedding_pool"] == 2 * dispatches, launches
        assert launches[scan] == dispatches, launches
    want = results["sync", "{}"]
    for key, got in results.items():
        if "coalesce" in key[1]:
            _served_close(got, want)
        else:
            _served_equal(got, want)
        assert stats[key] == stats["sync", "{}"], key
    assert stats["sync", "{}"]["cache_hits"] > 0


def test_drain_thread_serves_on_the_engines_device(cuda):
    eng, queries = _serving_setup(cuda, None)
    want = make_server(eng, "sync", max_batch=SERVE_BATCH).serve_many(
        queries)
    server = make_server(eng, "concurrent", max_batch=SERVE_BATCH,
                         tenants=2, autostart=False)
    dispatch, seen = server._inner._dispatch, []

    def recorded(parts):
        seen.append((threading.current_thread().name,
                     torch.cuda.current_device()))
        return dispatch(parts)

    server._inner._dispatch = recorded
    tickets = [server.submit(q) for q in queries]
    server.start()
    server.flush()
    got = [server.result(t, timeout=60) for t in tickets]
    server.close()
    assert seen and set(seen) == {("serving-drain", eng.device.index or 0)}
    assert server.stats()["n_errors"] == 0
    for g, w in zip(got, want):
        assert g.status == "ok"
        np.testing.assert_array_equal(g.scores, w.scores)


# ---------------------------------------------------------------------------
# the LM kernels: flash attention and int8 matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d,causal,q_offset", [
    (2, 128, 128, 64, True, 0), (1, 64, 192, 64, True, 128),
    (2, 100, 100, 32, False, 0), (3, 77, 130, 128, True, 53),
    (4, 256, 256, 128, True, 0), (2, 33, 33, 16, True, 0),
    (2, 8, 8, 16, True, -3),
    # the tensor-core kernel's tile edges: 64-row q tiles, 64-key tiles,
    # every head dim, q_offset on both sides, non-causal with sk > sq
    (3, 1, 1, 16, True, 0), (4, 1, 333, 128, True, 332),
    (2, 63, 100, 32, True, 37), (3, 65, 65, 64, True, 0),
    (2, 129, 300, 128, True, 171), (2, 200, 200, 128, True, 0),
    (2, 200, 150, 64, True, -45), (2, 65, 190, 16, False, 0),
    (1, 129, 1000, 128, False, 0), (2, 63, 127, 32, False, 0)])
def test_flash_attention_matches_plain(cuda, bh, sq, sk, d, causal,
                                       q_offset, dtype):
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device=cuda)
               .to(dtype) for s in (sq, sk, sk))
    before = build.FLASH_ATTENTION.launches
    got = ops.flash_attention_bhsd(q, k, v, causal=causal,
                                   q_offset=q_offset)
    torch.cuda.synchronize()
    assert build.FLASH_ATTENTION.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal,
                                   q_offset=q_offset)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_bf16_rows_without_a_valid_key_are_zero(cuda, d):
    """q_offset < 0 leaves the first rows with no key at or before them;
    the kernel's explicit 0 for masked probabilities and its clamped
    normalizer give exactly 0 there (exp(-1e30 - -1e30) would be 1)."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn((2, 150, d), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    got = ops.flash_attention_bhsd(q, k, v, causal=True, q_offset=-70)
    torch.cuda.synchronize()
    assert bool((got[:, :70] == 0).all())
    assert bool(torch.isfinite(got.float()).all())
    assert bool((got[:, 70:] != 0).any())
    want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=-70)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_flash_attention_op_folds_heads(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((2, 4, 96, 64), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    got = ops.flash_attention(q.transpose(1, 2).contiguous().transpose(
        1, 2), k, v)  # a non-contiguous q is taken
    want = ref.flash_attention_ref(q.reshape(8, 96, 64),
                                   k.reshape(8, 96, 64),
                                   v.reshape(8, 96, 64)).reshape(q.shape)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("m,k,n", [(8, 32, 16), (128, 256, 128),
                                   (100, 130, 50), (256, 512, 512),
                                   (1, 7, 3), (333, 4096, 129),
                                   # k % 32 != 0 and n, m off the 128 tile
                                   (257, 1008, 260), (200, 100, 130),
                                   (1024, 4096, 1024)])
def test_int8_matmul_equals_plain(cuda, m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    sx = torch.from_numpy((np.abs(rng.standard_normal((m, 1))) + 0.01)
                          .astype(np.float32))
    sw = torch.from_numpy((np.abs(rng.standard_normal((1, n))) + 0.01)
                          .astype(np.float32))
    args = [a.to(cuda) for a in (x, w, sx, sw)]
    before = build.INT8_MATMUL.launches
    got = ops.int8_matmul(*args)
    torch.cuda.synchronize()
    assert build.INT8_MATMUL.launches == before + 1
    assert torch.equal(got, ref.int8_matmul_ref(*args))
    assert torch.equal(got.cpu(), ref.int8_matmul_ref(x, w, sx, sw))


def test_lm_kernels_refuse_bad_input(cuda):
    q = torch.zeros((2, 8, 64), device=cuda)
    with pytest.raises(ValueError):  # dtype
        ops.flash_attention_bhsd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):  # mixed dtypes
        ops.flash_attention_bhsd(q, q.bfloat16(), q)
    with pytest.raises(ValueError):  # device
        ops.flash_attention_bhsd(q, q.cpu(), q)
    with pytest.raises(ValueError):  # head dim
        z = torch.zeros((2, 8, 48), device=cuda)
        ops.flash_attention_bhsd(z, z, z)
    with pytest.raises(ValueError):  # shapes
        ops.flash_attention_bhsd(q, q[:1], q[:1])
    with pytest.raises(ValueError):  # not 16-byte aligned (cp.async)
        u = torch.zeros(2 * 8 * 64 + 1, dtype=torch.bfloat16,
                        device=cuda)[1:].view(2, 8, 64)
        assert u.is_contiguous()
        ops.flash_attention_bhsd(u, u, u)
    x = torch.zeros((4, 8), dtype=torch.int8, device=cuda)
    s4, s1 = torch.ones((4, 1), device=cuda), torch.ones((1, 4), device=cuda)
    with pytest.raises(ValueError):  # dtype
        ops.int8_matmul(x.float(), x.T.contiguous(), s4, s1)
    with pytest.raises(ValueError):  # device
        ops.int8_matmul(x, x.T.contiguous().cpu(), s4, s1)
    with pytest.raises(ValueError):  # shape
        ops.int8_matmul(x, x.T.contiguous(), s1, s1)
    with pytest.raises(ValueError):  # inner dims
        ops.int8_matmul(x, x, s4, torch.ones((1, 8), device=cuda))
    big_k = 131072  # k * 128**2 reaches 2**31: the int32 sum could wrap
    with pytest.raises(ValueError):
        ops.int8_matmul(torch.zeros((4, big_k), dtype=torch.int8,
                                    device=cuda),
                        torch.zeros((big_k, 4), dtype=torch.int8,
                                    device=cuda), s4, s1)


# ---------------------------------------------------------------------------
# the live and tiered catalogs on the card
# ---------------------------------------------------------------------------
def _side_table(rng, ids, d, capacity, device):
    """A side table holding `ids` (ascending) with random int8 rows,
    EMPTY_ID-padded to `capacity`."""
    from repro_torch.core.nns import EMPTY_ID

    ids = np.sort(np.asarray(ids, np.int32))
    full = np.full(capacity, EMPTY_ID, np.int32)
    full[:ids.size] = ids
    values, scales = _pool_table(rng, capacity, d, device)
    return ops.SideTable(ids=torch.from_numpy(full).to(device),
                         values=values, scales=scales)


@pytest.mark.parametrize("case", ["empty", "full", "out_of_range",
                                  "no_base", "large"])
def test_side_table_pool_equals_plain(cuda, case):
    """The pool kernel's side table (the live delta, the tiered overlay)
    bit for bit with the plain version, counters included: an empty delta
    (all EMPTY_ID; ids past the table then read zeros), a full 1024-slot
    delta overlapping the ids, ids past the base table that hit or miss
    it, a segment with no base rows (every miss reads zeros, hot hits
    still count), and a side table too large for shared memory; the side
    table static in the plan and given per call."""
    rng = np.random.default_rng(sum(map(ord, case)))
    n, d, B, L = 4000, 32, 64, 20
    values, scales = _pool_table(rng, n, d, cuda)
    pick = torch.from_numpy(rng.choice(n, 24, replace=False)).to(cuda)
    hot_ids, hot_rows = _pinned(values, scales, pick, 32)
    hot_np = hot_ids.cpu().numpy()
    if case == "no_base":
        values, scales = values[:0], scales[:0]
    ids_np = rng.integers(-1, n + 40, size=(B, L)).astype(np.int32)
    if case == "empty":
        side_ids, cap = [], 1024
    elif case == "large":
        side_ids, cap = rng.choice(n + 40, 3000 - 40, replace=False), 3000
        side_ids = side_ids[~np.isin(side_ids, hot_np)]
    elif case == "no_base":  # the overlay: every present id, hot ones too
        side_ids, cap = np.unique(ids_np[(ids_np >= 0) & (ids_np < n)]), \
            B * L
    else:
        cand = np.setdiff1d(np.arange(n + 40), hot_np)
        side_ids = rng.choice(cand, 1024 if case == "full" else 200,
                              replace=False)
        cap = 1024
    side = _side_table(rng, side_ids, d, cap, cuda)
    ids = torch.from_numpy(ids_np).to(cuda)
    valid = torch.from_numpy(np.arange(B) % 7 != 3).to(cuda)
    w = torch.from_numpy(rng.normal(size=(B, L)).astype(np.float32)).to(cuda)
    for static in (True, False):
        segs = [ops.PoolSegment(values, scales, mode=m, column=c,
                                hot_ids=hot_ids, hot_rows=hot_rows,
                                counted=True,
                                side=side if static else None)
                for m, c in (("mean", 0), ("rows", d))]
        plan = ops.PoolPlan(segs)
        outs = [torch.full((B, 2 * d), 9.0, device=cuda),
                torch.full((B, L, 2 * d), 9.0, device=cuda)]
        sides = None if static else [side, side]
        got = [o.clone() for o in outs]
        before = build.EMBEDDING_POOL.launches
        counts = ops.grouped_pool(plan, [ids, ids], got, valid, [w, None],
                                  sides)
        torch.cuda.synchronize()
        assert build.EMBEDDING_POOL.launches == before + 1
        want = [o.clone() for o in outs]
        with _plain("embedding_pool"):
            want_counts = ops.grouped_pool(plan, [ids, ids], want, valid,
                                           [w, None], sides)
        for g, wt in zip(got, want):
            assert torch.equal(g, wt), (case, static)
        assert torch.equal(counts, want_counts), (case, static)
        assert int(counts[0]) > 0


def _live_setup(device, scan_block, rng):
    eng, queries = _serving_setup(device, scan_block)
    from repro_torch.serving import LiveCatalog

    cat = LiveCatalog(eng, delta_capacity=64)
    d = eng.cfg.embed_dim
    hot = eng.item_hot.hot_ids[:5].cpu().numpy()
    cat.upsert(np.r_[hot, 2000, 2003],
               rng.normal(size=(7, d)).astype(np.float32))
    cat.delete([11, 2003])
    return cat, queries


@pytest.mark.parametrize("scan_block", [None, 128])
def test_live_engine_serves_like_the_plain_versions(cuda, scan_block):
    """A live engine with pending upserts, re-embedded hot rows and
    deletes serves the same bits with the kernels, with the plain versions
    (`REPRO_TORCH_*=torch`) and as its `rebuild_reference()`, counters
    included; a batch launches the pool twice, the delta scan's Hamming
    kernel once, and the base scan's kernel once."""
    rng = np.random.default_rng(3)
    cat, queries = _live_setup(cuda, scan_block, rng)
    batch = make_server(cat.engine, "sync", max_batch=SERVE_BATCH)._stack_np(
        list(queries[:SERVE_BATCH]), SERVE_BATCH)
    batch["history"][:, 0] = 2003  # a retired new id: reads zeros
    build.reset_launches()
    got = cat.engine.serve(batch)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    assert counts["embedding_pool"] == 2
    if scan_block is None:
        assert counts["hamming_distances"] == 2 and counts[
            "streaming_nns"] == 0
    else:
        assert counts["hamming_distances"] == 1 and counts[
            "streaming_nns"] == 1
    with _plain("hamming_distances", "embedding_pool", "streaming_nns"):
        plain = cat.engine.serve(batch)
    assert build.launch_counts() == counts
    for other in (plain, cat.rebuild_reference().serve(batch)):
        assert torch.equal(got.items, other.items)
        assert torch.equal(got.topk.scores, other.topk.scores)
        for f in ("indices", "distances", "counts", "blocks_touched"):
            a, b = getattr(got.nns, f), getattr(other.nns, f)
            assert (a is None and b is None) or torch.equal(a, b), f
        assert got.stats.as_dict() == other.stats.as_dict()


def test_outofcore_scan_equals_resident_scan(cuda, tmp_path):
    """The out-of-core scan over a memmap (pinned staging, one masked
    streaming launch a chunk, the row remap on the card) equals the
    resident pruned streaming scan with the same mask and summary."""
    from repro_torch.core.nns import out_of_core_nns

    rng = np.random.default_rng(4)
    n, q, words = 70_000, 64, 8
    db_np = rng.integers(0, 2**32, (n, words), dtype=np.uint32)
    mm = np.memmap(tmp_path / "sigs.bin", dtype=np.uint32, mode="w+",
                   shape=(n, words))
    mm[:] = db_np
    mm.flush()
    alive = rng.random(n) > 0.05
    db = torch.from_numpy(db_np.view(np.int32)).to(cuda)
    qs = torch.cat([db[:q // 2], _sigs(rng, q - q // 2, words, cuda)])
    summary = build_block_summary(db, 4096, db_mask=alive)
    mask = torch.from_numpy(alive).to(cuda)
    want = fixed_radius_nns(qs, db, 100, 50, db_mask=mask, scan_block=4096,
                            summary=summary)
    build.reset_launches()
    got = out_of_core_nns(qs, mm, 100, 50, db_mask=alive, summary=summary,
                          chunk_rows=1 << 14)
    torch.cuda.synchronize()
    assert build.launch_counts()["streaming_nns"] == -(-n // (1 << 14))
    for f in ("indices", "distances", "counts", "blocks_touched"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_live_compact_during_pipelined_serving_depth3(cuda):
    """An epoch swap under the pipelined ring at depth 3 on the card:
    buckets dispatched before `compact` finish on the old epoch, later
    ones serve the new one, and each equals sync serving of its epoch's
    rebuilt reference bit for bit."""
    from repro_torch.serving import LiveCatalog

    rng = np.random.default_rng(5)
    eng, queries = _serving_setup(cuda, None)
    d = eng.cfg.embed_dim
    cat = LiveCatalog(eng, delta_capacity=64)
    cat.upsert(np.arange(2000, 2004), rng.normal(size=(4, d))
               .astype(np.float32))
    old_ref = cat.rebuild_reference()
    pipe = make_server(cat.engine, "pipelined", max_batch=SERVE_BATCH,
                       depth=3)
    cat.attach(pipe)
    tickets = [pipe.submit(q) for q in queries]
    for _ in range(2):
        pipe._ring.append(pipe._dispatch(pipe._take_parts()))
    cat.upsert(np.arange(2004, 2008), rng.normal(size=(4, d))
               .astype(np.float32))
    cat.compact()
    new_ref = cat.rebuild_reference()
    pipe.flush()
    got = [pipe.result(t) for t in tickets]
    cut = 2 * SERVE_BATCH
    old = make_server(old_ref, "sync", max_batch=SERVE_BATCH).serve_many(
        queries)
    new = make_server(new_ref, "sync", max_batch=SERVE_BATCH).serve_many(
        queries)
    _served_equal(got[:cut], old[:cut])
    _served_equal(got[cut:], new[cut:])
    _served_equal(pipe.serve_many(queries), new)


def test_live_pipelined_dispatch_never_waits_on_the_host(cuda):
    """A live engine's buckets (delta scan, merge, side tables) dispatch
    under `set_sync_debug_mode("error")` and serve sync's bits."""
    rng = np.random.default_rng(6)
    cat, queries = _live_setup(cuda, 128, rng)
    want = make_server(cat.engine, "sync", max_batch=SERVE_BATCH
                       ).serve_many(queries)
    server = make_server(cat.engine, "pipelined", max_batch=SERVE_BATCH,
                         depth=2)
    server.serve_many(queries[:SERVE_BATCH])
    dispatch = server._dispatch

    def checked(parts):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(parts)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    server._dispatch = checked
    _served_equal(server.serve_many(queries), want)
    assert server.stats()["n_errors"] == 0


# ---------------------------------------------------------------------------
# training and train-while-serve on the card
# ---------------------------------------------------------------------------
def _train_setup(n_items=300):
    data = synthetic.make_movielens(n_users=200, n_items=n_items,
                                    history_len=8)
    cfg = default_youtubednn_config()._replace(
        n_items=n_items, history_len=8,
        user_features={"user_id": data.n_users, "gender": 3, "age": 7,
                       "occupation": 21, "zip_bucket": 250})
    params = _numpy_params(cfg, np.random.default_rng(7))
    return data, cfg, params


def _run_steps(cfg, params, batches, device):
    state = training.init_recsys_train_state(params, device)
    step = training.make_recsys_train_step(cfg)
    losses = []
    for b in batches:
        state, loss = step(state, b)
        losses.append(loss)
    return state, torch.stack(losses).cpu()


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Five steps on the card and on the CPU from the same parameters:
    losses within rtol 1e-5, parameters within 1e-6 in all but 0.1% of
    entries and within 5e-5 everywhere. cuBLAS and the CPU sum the
    gradients in other orders, and AdamW's g / (sqrt(v) + eps) moves by up
    to a few percent of lr where a gradient entry is near eps (1e-8)."""
    data, cfg, params = _train_setup()
    batches = list(synthetic.movielens_batches(data, 64, 5))
    gpu, gpu_loss = _run_steps(cfg, params, batches, cuda)
    cpu, cpu_loss = _run_steps(cfg, params, batches, "cpu")
    np.testing.assert_allclose(gpu_loss.numpy(), cpu_loss.numpy(),
                               rtol=1e-5)
    got = torch.cat([t.cpu().ravel() for t in tree_leaves(gpu.params)])
    want = torch.cat([t.ravel() for t in tree_leaves(cpu.params)])
    diff = (got - want).abs()
    assert (diff > 1e-6).float().mean() <= 0.001 and diff.max() <= 5e-5


def test_train_step_is_deterministic_on_the_card(cuda):
    """Two runs of the same steps end in the same bits (the embedding
    gathers' backward scatter-adds the history and logits gradients into
    the item table), and the step queues without a host sync."""
    data, cfg, params = _train_setup()
    batches = [training.batch_to_device(b, cuda) for b in
               synthetic.movielens_batches(data, 256, 6)]
    torch.cuda.synchronize()
    a, la = _run_steps(cfg, params, batches, cuda)
    b, lb = _run_steps(cfg, params, batches, cuda)
    assert torch.equal(la, lb)
    for x, y in zip(tree_leaves([a.params, a.opt.mu, a.opt.nu]),
                    tree_leaves([b.params, b.opt.mu, b.opt.nu])):
        assert torch.equal(x, y)
    step = training.make_recsys_train_step(cfg)
    torch.cuda.set_sync_debug_mode("error")
    try:
        a, loss = step(a, batches[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(loss).item()


def _online_setup(device, fold_every):
    data, cfg, params = _train_setup()
    rng = np.random.default_rng(8)
    proj = torch.from_numpy(rng.standard_normal((32, 256))
                            .astype(np.float32))
    eng = trs.RecSysEngine.build(params, cfg, lsh_proj=proj, radius=112,
                                 n_candidates=32, hot_rows=64,
                                 device=device)
    cat = LiveCatalog(eng, delta_capacity=cfg.n_items)
    return data, cat, OnlineTrainer(cat, cfg, params, fold_every=fold_every,
                                    compact_every=3)


def test_step_without_fold_changes_nothing_served_on_the_card(cuda):
    data, cat, trainer = _online_setup(cuda, fold_every=0)
    server = make_server(cat.engine, "pipelined", max_batch=SERVE_BATCH,
                         depth=2)
    cat.attach(server)
    queries = synthetic.serving_queries(data, np.arange(100))
    published = cat.engine
    params_before = [t.clone() for t in tree_leaves(published.params)]
    before = server.serve_many(queries)
    trainer.step(next(synthetic.movielens_batches(data, 64, 1)))
    assert cat.engine is published
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(published.params), params_before))
    _served_equal(server.serve_many(queries), before)


def test_shadow_gap_is_zero_after_folds_on_the_card(cuda):
    data, cat, trainer = _online_setup(cuda, fold_every=1)
    shadow = ShadowHarness(trainer, data, k=10, probe_batch=128)
    for b in synthetic.movielens_batches(data, 64, 7):
        trainer.step(b)
    rec = shadow.checkpoint()
    assert rec.gap == 0.0 and rec.agree_frac == 1.0
    assert cat.epoch == 2 and trainer.n_folds == 8
    queries = synthetic.serving_queries(data, np.arange(100))
    _served_equal(
        make_server(cat.engine, "sync", max_batch=SERVE_BATCH
                    ).serve_many(queries),
        make_server(rebuild_from_params(cat.engine, trainer.params), "sync",
                    max_batch=SERVE_BATCH).serve_many(queries))


# ---------------------------------------------------------------------------
# the multi-GPU plans: NCCL at world size 1, and banks on one card
# ---------------------------------------------------------------------------
@pytest.fixture
def nccl(cuda, tmp_path):
    """A world-size-1 NCCL group (`file://` rendezvous in `tmp_path`)."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(cuda.index or 0)
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def _same_serve(got, want, blocks=True):
    assert torch.equal(got.items, want.items)
    assert torch.equal(got.topk.scores, want.topk.scores)
    assert got.stats.as_dict() == want.stats.as_dict()
    for f in ("indices", "distances", "counts", "blocks_touched"):
        a, b = getattr(got.nns, f), getattr(want.nns, f)
        if f == "blocks_touched" and (not blocks or a is None or b is None):
            continue
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))


@pytest.mark.parametrize("scan_block", [None, 128])
def test_nccl_mesh_engine_serves_like_the_local_engine(cuda, nccl,
                                                       scan_block):
    """Sharded as banks, as a query axis and as a 1 x 1 grid over NCCL:
    the unsharded engine's bits and launches; a live update and a
    compaction on the grid engine serve `rebuild_reference()`'s bits."""
    from repro_torch.utils import make_mesh

    eng, queries = _serving_setup(cuda, scan_block)
    batch = {k: np.stack([q[k] for q in queries[:SERVE_BATCH]])
             for k in queries[0]}
    eng.serve(batch)
    build.reset_launches()
    want = eng.serve(batch)
    local = build.launch_counts()
    grid = make_mesh((1, 1), ("qp", "banks"))
    for mesh, axis, qaxis in ((make_mesh((1,), ("banks",)), "banks", None),
                              (make_mesh((1,), ("qp",)), None, "qp"),
                              (grid, "banks", "qp")):
        sharded = eng.shard(mesh, axis, query_axis=qaxis)
        sharded.serve(batch)
        build.reset_launches()
        got = sharded.serve(batch)
        assert build.launch_counts() == local
        _same_serve(got, want)
    cat = LiveCatalog(eng.shard(grid, "banks", query_axis="qp"),
                      delta_capacity=32)
    rng = np.random.default_rng(3)
    cat.upsert(np.arange(2000, 2008),
               rng.standard_normal((8, 32)).astype(np.float32))
    cat.delete([3, 2001])
    _same_serve(cat.engine.serve(batch),
                cat.rebuild_reference().serve(batch), blocks=False)
    cat.compact()
    assert cat.engine.nns_mesh is grid and cat.engine.nns_axis == "banks"
    _same_serve(cat.engine.serve(batch),
                cat.rebuild_reference().serve(batch), blocks=False)


@pytest.mark.parametrize("scan_block", [None, 128])
def test_nccl_concurrent_stream_serves_like_sync(cuda, nccl, scan_block,
                                                 tmp_path):
    """The concurrent front-end on a world-size-1 NCCL mesh engine (the
    1 x 1 grid): its stream broadcasts each chunk from the drain thread
    as CUDA tensors, and it serves sync's bits; a LiveCatalog update and
    a compaction inside the pause window between two staged halves, each
    half sync's bits on its epoch; a bank-sharded snapshot restores
    bit-equal."""
    from repro_torch.utils import make_mesh

    eng, queries = _serving_setup(cuda, scan_block)
    grid = make_mesh((1, 1), ("qp", "banks"))
    sharded = eng.shard(grid, "banks", query_axis="qp")
    sync = make_server(sharded, "sync", max_batch=SERVE_BATCH)
    want = sync.serve_many(queries)
    sync.close()
    conc = make_server(sharded, "concurrent", max_batch=SERVE_BATCH,
                       queue_depth=None, autostart=False)
    tickets = [conc.submit(q) for q in queries]
    conc.start()
    _served_equal([conc.result(t, timeout=60) for t in tickets], want)
    conc.close()
    assert sum(c[2] for c in conc.chunk_log) == len(queries)
    assert {c[1] for c in conc.chunk_log} == {0}

    cat = LiveCatalog(sharded, delta_capacity=32)
    conc = make_server(cat.engine, "concurrent", max_batch=SERVE_BATCH,
                       queue_depth=None, autostart=False)
    cat.attach(conc)
    before = cat.engine
    first, second = queries[:SERVE_BATCH], queries[SERVE_BATCH:]
    tickets = [conc.submit(q) for q in first]
    conc.start()
    got1 = [conc.result(t, timeout=60) for t in tickets]
    rng = np.random.default_rng(3)
    cat.upsert(np.arange(2000, 2008),
               rng.standard_normal((8, 32)).astype(np.float32))
    cat.compact()
    with conc._cv:  # one chunk: sync's buckets
        tickets = [conc.submit(q) for q in second]
    got2 = [conc.result(t, timeout=60) for t in tickets]
    conc.close()
    assert [c[1] for c in conc.chunk_log] == [1, 3]
    _served_equal(got1, make_server(before, "sync", max_batch=SERVE_BATCH
                                    ).serve_many(first))
    _served_equal(got2, make_server(cat.engine, "sync",
                                    max_batch=SERVE_BATCH
                                    ).serve_many(second))
    cat.snapshot(tmp_path / "snap")
    back = LiveCatalog(eng.shard(grid, "banks", query_axis="qp"))
    back.restore(tmp_path / "snap")
    assert back.engine.nns_mesh is grid and back.epoch == cat.epoch
    batch = {k: np.stack([q[k] for q in queries[:SERVE_BATCH]])
             for k in queries[0]}
    _same_serve(back.engine.serve(batch), cat.engine.serve(batch),
                blocks=False)


@pytest.mark.parametrize("n,n_banks,block_rows", [(65536, 4, 4096),
                                                  (3000, 3, None),
                                                  (3000, 7, None)])
def test_bank_scan_merge_equals_local_plan_on_the_card(cuda, n, n_banks,
                                                       block_rows):
    """`bank_scan` of every bank and `merge_banks`, no collective: the
    local plan's bits (pruned streaming banks of whole summary blocks, or
    dense banks, 7 of them padded), and the plain versions'."""
    from repro_torch.core.nns import bank_scan, merge_banks
    from repro_torch.utils import bank_slice

    rng = np.random.default_rng(n_banks)
    db = _sigs(rng, n, 8, cuda)
    q = db[rng.choice(n, 64)].clone()
    q[:, 0] ^= 0x0F0F
    scan = 4096 if block_rows else 0
    summary = (build_block_summary(db, block_rows) if block_rows else None)
    want = fixed_radius_nns(q, db, 100, 50, scan_block=scan, summary=summary)
    banks = [bank_slice(db, n_banks, b) for b in range(n_banks)]
    per = banks[0].shape[0]
    sums = [None] * n_banks
    if block_rows:
        nb = per // block_rows
        sums = [type(summary)(*(x[b * nb:(b + 1) * nb] for x in (
            summary.or_sigs, summary.and_sigs, summary.min_pc,
            summary.max_pc, summary.n_alive)), block_rows=block_rows)
            for b in range(n_banks)]

    def merged():
        return merge_banks([bank_scan(q, banks[b], 100, 50, bank=b,
                                      n_valid=n, scan_block=scan,
                                      summary=sums[b])
                            for b in range(n_banks)], 50)

    build.reset_launches()
    got = merged()
    counts = build.launch_counts()
    assert counts["streaming_nns" if block_rows else "hamming_distances"] \
        == n_banks
    with _plain("hamming_distances", "streaming_nns"):
        plain = merged()
    for f in ("indices", "distances", "counts", "blocks_touched"):
        a, b, p = (getattr(r, f) for r in (got, want, plain))
        assert (a is None) == (b is None) == (p is None)
        assert a is None or (torch.equal(a, b) and torch.equal(a, p))
    assert (got.blocks_touched is not None) == bool(block_rows)


# ---------------------------------------------------------------------------
# LM training on the card
# ---------------------------------------------------------------------------
def _lm_setup(accum=2, **kw):
    cfg = reduce_config(get_arch("qwen3-8b").model).with_(n_layers=2, **kw)
    pcfg = ParallelConfig(remat="block", logit_chunk=8,
                          grad_accum={"tiny": accum})
    shape = ShapeConfig("tiny", "train", 16, 2 * accum)
    return cfg, pcfg, training.make_train_step(cfg, pcfg, shape,
                                               base_lr=1e-2, warmup=2,
                                               total_steps=20)


def _lm_batch(vocab, accum, seed, high=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, high or vocab, (accum, 2, 17))
    return {"tokens": toks[..., :-1].astype(np.int32),
            "labels": toks[..., 1:].astype(np.int32)}


def _to(state, device):
    """A float32-state `TrainState` (no error buffer) on `device`."""
    opt = state.opt
    return training.TrainState(
        params=tree_map(lambda t: t.to(device), state.params),
        opt=type(opt)(mu=tree_map(lambda t: t.to(device), opt.mu),
                      nu=tree_map(lambda t: t.to(device), opt.nu),
                      count=opt.count.to(device)),
        step=state.step.to(device))


def test_lm_train_step_on_the_card_matches_the_cpu(cuda):
    """Five steps, each from the CPU's state carried to the card: loss and
    grad norm within rtol 1e-5, parameters within 1e-6 in all but 0.1% of
    entries and within 1e-3 (a tenth of lr) everywhere, the tolerances
    the CPU port is held to against the reference
    (`tests/test_torch_lm_training.py`)."""
    cfg, pcfg, step = _lm_setup()
    cpu = training.init_train_state(cfg, pcfg,
                                     torch.Generator().manual_seed(0), "cpu")
    for i in range(5):
        batch = _lm_batch(cfg.vocab_size, 2, seed=i)
        gpu, gm = step(_to(cpu, cuda), batch)
        cpu, cm = step(cpu, batch)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(gm[key]), float(cm[key]),
                                       rtol=1e-5, err_msg=f"{key} {i}")
        got = torch.cat([t.cpu().ravel() for t in tree_leaves(gpu.params)])
        want = torch.cat([t.ravel() for t in tree_leaves(cpu.params)])
        diff = (got - want).abs()
        assert (diff > 1e-6).float().mean() <= 0.001 and diff.max() <= 1e-3


def test_lm_train_step_is_deterministic_on_the_card(cuda):
    """bf16 params, many repeated token ids (the embedding gather's
    backward), int8 states and compression: two runs of two steps from
    one state end in the same bits."""
    cfg, pcfg, _ = _lm_setup(dtype="bfloat16")
    pcfg = pcfg.with_(opt_state_dtype="int8", grad_compression=True)
    step = training.make_train_step(cfg, pcfg, ShapeConfig(
        "tiny", "train", 16, 4), base_lr=1e-2, warmup=2, total_steps=20)
    state = training.init_train_state(
        cfg, pcfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    batches = [_lm_batch(cfg.vocab_size, 2, seed=i, high=5) for i in (0, 1)]
    runs = []
    for _ in range(2):
        s = state
        for b in batches:
            s, m = step(s, b)
        runs.append((s, m))
    (a, ma), (b, mb) = runs
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for x, y in zip(
            tree_leaves([a.params, a.err_buf, a.opt.count, a.step]),
            tree_leaves([b.params, b.err_buf, b.opt.count, b.step])):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves([a.opt.mu, a.opt.nu]),
                    tree_leaves([b.opt.mu, b.opt.nu])):
        assert torch.equal(x.values, y.values)
        assert torch.equal(x.scales, y.scales)


@pytest.mark.parametrize("case", [(2, 2, 2, 32, 32, 16, True, 0, 8),
                                  (1, 2, 2, 8, 40, 16, True, 32, 16),
                                  (2, 3, 2, 11, 29, 16, False, 0, 8),
                                  (1, 8, 4, 300, 300, 128, True, 0, 128)])
def test_attention_backward_on_the_card_matches_the_cpu(cuda, case):
    """The custom backward's dq, dk, dv on the card within 1e-5 of its CPU
    run (float32, TF32 off on both; sums in other orders)."""
    B, R, G, Sq, Sk, hd, causal, off, bk = case
    rng = np.random.default_rng(0)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((B, R, G, Sq, hd), (B, R, Sk, hd),
                               (B, R, Sk, hd), (B, R, G, Sq, hd)))
    outs = []
    for dev in ("cpu", cuda):
        qq, kk, vv = (t.to(dev).requires_grad_(True) for t in (q, k, v))
        out = tattn.gqa_blocked_attention(qq, kk, vv, causal=causal,
                                          q_offset=off, block_k=bk)
        outs.append([out] + list(torch.autograd.grad(
            out, (qq, kk, vv), dout.to(dev))))
    for c, g in zip(*outs):
        np.testing.assert_allclose(g.detach().cpu().numpy(),
                                   c.detach().numpy(), rtol=1e-5, atol=1e-5)



# ---------------------------------------------------------------------------
# the MoE, SSM and hybrid LM families
# ---------------------------------------------------------------------------
NEW_FAMILIES = ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b",
                "mamba2-1.3b", "zamba2-1.2b")


def _family_setup(arch):
    from repro_torch.models import transformer as ttf

    cfg = reduce_config(get_arch(arch).model)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params, tree_map(lambda t: t.cuda(), params)


def _family_tol(cfg):
    """MoE experts run in bfloat16 on both devices (the reference's
    dtypes), so their sums in cuBLAS's order round a bfloat16 step apart:
    1e-2 of the largest logit. The rest is float32 with TF32 off: 1e-4."""
    return 1e-2 if cfg.family == "moe" else 1e-4


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_new_families_on_the_card_match_the_cpu(cuda, arch):
    """Reduced configs: train-mode logits and aux loss, prefill logits and
    a decode step from the CPU's cache tree carried to the card, within
    `_family_tol` of the largest logit; no port kernel launches on the
    blocked path."""
    from repro_torch.models import transformer as ttf
    from repro_torch.serving import engine as teng

    cfg, cpu_p, gpu_p = _family_setup(arch)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32)
    tol = _family_tol(cfg)

    def close(g, c):
        c = c.float()
        assert (g.float().cpu() - c).abs().max() <= tol * c.abs().max()

    ops.reset_launches()
    outs = [ttf.forward(p, cfg, {"tokens": toks}, mode="train",
                        logits_mode="all") for p in (cpu_p, gpu_p)]
    close(outs[1].logits, outs[0].logits)
    np.testing.assert_allclose(float(outs[1].aux_loss),
                               float(outs[0].aux_loss), rtol=tol)
    pre = [teng.prefill(p, cfg, {"tokens": toks[:, :16]}, cache_len=20,
                        cache_dtype="bfloat16") for p in (cpu_p, gpu_p)]
    close(pre[1].logits, pre[0].logits)
    carried = tree_map(lambda t: t.cuda(), pre[0].caches)
    dec = [teng.decode_step(p, cfg, {"tokens": toks[:, 16:]}, c, 16)
           for p, c in ((cpu_p, pre[0].caches), (gpu_p, carried))]
    close(dec[1].logits, dec[0].logits)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("arch,n_attn", [("phi3.5-moe-42b-a6.6b", 4),
                                         ("llama4-maverick-400b-a17b", 4),
                                         ("zamba2-1.2b", 3)])
def test_new_families_flash_prefill_on_the_card(cuda, arch, n_attn):
    """bf16 weights: the flash prefill launches the kernel once per
    attention invocation (every layer; the hybrid's 2 groups and its
    remainder) and its last-token logits agree with the blocked
    prefill's within 5% of each row's spread."""
    from repro_torch.models import transformer as ttf
    from repro_torch.serving import engine as teng

    cfg = reduce_config(get_arch(arch).model).with_(dtype="bfloat16")
    params = ttf.init_params(cfg, torch.Generator(device=cuda).manual_seed(
        0), cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)).to(cuda)
    kw = dict(cache_len=72, cache_dtype="int8")
    blocked = teng.prefill(params, cfg, {"tokens": toks}, **kw)
    ops.reset_launches()
    flash = teng.prefill(params, cfg, {"tokens": toks}, attn_impl="flash",
                         **kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == n_attn
    assert sum(counts.values()) == n_attn
    lb, lf = blocked.logits[:, -1].float(), flash.logits[:, -1].float()
    spread = lb.max(-1).values - lb.min(-1).values
    assert bool(((lf - lb).abs().max(-1).values <= 0.05 * spread).all())


@pytest.mark.parametrize("bh,d", [(160, 128), (128, 64), (256, 128),
                                  (512, 128)])
def test_flash_attention_at_the_new_families_shapes(cuda, bh, d):
    """The prefill shapes of llama4-maverick (40 heads x batch 4, d 128),
    zamba2 and musicgen-large (32 heads x batch 4, d 64), qwen2-vl-72b (64
    heads x batch 4) and llama3-405b (128 heads x batch 4, d 128) at 2,048
    tokens, bf16 causal, against the plain version (2e-2, as every bf16
    case)."""
    gen = torch.Generator(device=cuda).manual_seed(bh + d)
    q, k, v = (torch.randn((bh, 2048, d), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    before = build.FLASH_ATTENTION.launches
    got = ops.flash_attention_bhsd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert build.FLASH_ATTENTION.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# the VLM, audio and largest dense configs
# ---------------------------------------------------------------------------
VLM_AUDIO_DENSE = ("qwen2-vl-72b", "musicgen-large", "llama3-405b")


def _prompt(cfg, B, S, seed):
    """numpy tokens (the audio model's (B, K, S) grid); for the VLM also
    float32 patch embeddings at slots 2.. of every row and (3, B, S)
    M-RoPE positions whose components differ there."""
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks, S) if cfg.family == "audio" else (B, S)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.family == "vlm":
        nv = cfg.vision_tokens
        out["vision_embeds"] = rng.standard_normal(
            (B, nv, cfg.d_model)).astype(np.float32)
        out["vision_pos"] = np.broadcast_to(
            np.arange(2, 2 + nv, dtype=np.int32), (B, nv)).copy()
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
        pos[1, :, 2:2 + nv] += np.arange(nv, dtype=np.int32)
        pos[2, :, 2:2 + nv] -= np.arange(nv, dtype=np.int32)
        out["positions"] = pos
    return out


def _cut(batch, n):
    out = dict(batch, tokens=batch["tokens"][..., :n])
    if "positions" in batch:
        out["positions"] = batch["positions"][..., :n]
    return out


@pytest.mark.parametrize("arch", VLM_AUDIO_DENSE)
def test_vlm_audio_dense_on_the_card_match_the_cpu(cuda, arch):
    """Reduced float32 configs with TF32 off: train-mode logits, lm_loss,
    prefill logits and a decode step from the CPU's cache carried to the
    card, within 1e-4 of the largest logit (the loss within 1e-5
    relative: float32 sums in cuBLAS's order); the audio model's K
    codebook rows are summed in the same order on both devices. No port
    kernel launches on the blocked path."""
    from repro_torch.models import transformer as ttf
    from repro_torch.serving import engine as teng

    cfg, cpu_p, gpu_p = _family_setup(arch)
    b = _prompt(cfg, 2, 17, seed=1)
    tol = 1e-4

    def close(g, c):
        c = c.float()
        assert (g.float().cpu() - c).abs().max() <= tol * c.abs().max()

    ops.reset_launches()
    outs = [ttf.forward(p, cfg, b, mode="train", logits_mode="all")
            for p in (cpu_p, gpu_p)]
    close(outs[1].logits, outs[0].logits)
    labels = np.roll(b["tokens"], -1, axis=-1)
    pcfg = ParallelConfig(logit_chunk=8)
    losses = [training.lm_loss(p, cfg, pcfg, {**b, "labels": labels})[0]
              for p in (cpu_p, gpu_p)]
    np.testing.assert_allclose(float(losses[1]), float(losses[0]),
                               rtol=1e-5)
    pre = [teng.prefill(p, cfg, _cut(b, 16), cache_len=20,
                        cache_dtype="bfloat16") for p in (cpu_p, gpu_p)]
    close(pre[1].logits, pre[0].logits)
    carried = tree_map(lambda t: t.cuda(), pre[0].caches)
    last = {"tokens": b["tokens"][..., 16:]}
    dec = [teng.decode_step(p, cfg, last, c, 16)
           for p, c in ((cpu_p, pre[0].caches), (gpu_p, carried))]
    close(dec[1].logits, dec[0].logits)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("arch", VLM_AUDIO_DENSE)
def test_vlm_audio_dense_flash_prefill_on_the_card(cuda, arch):
    """bf16 weights: the flash prefill launches the kernel once a layer,
    and its last-token logits agree with the blocked prefill's within 5%
    of each row's spread (the audio model's: each codebook's) over the
    real vocabulary."""
    from repro_torch.models import transformer as ttf
    from repro_torch.serving import engine as teng

    cfg = reduce_config(get_arch(arch).model).with_(dtype="bfloat16")
    params = ttf.init_params(cfg, torch.Generator(device=cuda).manual_seed(
        0), cuda)
    b = _prompt(cfg, 2, 64, seed=2)
    kw = dict(cache_len=72, cache_dtype="int8")
    blocked = teng.prefill(params, cfg, b, **kw)
    ops.reset_launches()
    flash = teng.prefill(params, cfg, b, attn_impl="flash", **kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == cfg.n_layers
    assert sum(counts.values()) == cfg.n_layers
    V = cfg.vocab_size
    lb, lf = (o.logits[:, -1][..., :V].reshape(-1, V).float()
              for o in (blocked, flash))
    spread = lb.max(-1).values - lb.min(-1).values
    assert bool(((lf - lb).abs().max(-1).values <= 0.05 * spread).all())
