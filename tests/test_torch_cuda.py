"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports neither JAX nor the reference package, so it also runs
where only PyTorch is installed; from the repository root:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` because `tests/conftest.py` imports JAX.) The plain
versions are themselves held against the JAX reference on the CPU by
`tests/test_torch_kernels.py`, `tests/test_torch_core.py` and
`tests/test_torch_engine.py`. Integer outputs must be equal; the pool's
floats are held to 1e-6 of the pooled magnitudes, as there. The flash
kernel is held to 2e-5 in float32 and 2e-2 in bfloat16 (the Pallas
kernel's tolerances in `tests/test_kernels.py`; both sides accumulate in
float32 in another order), the int8 matmul bit for bit.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

from repro_torch.core.nns import (
    _prune_mask,
    build_block_summary,
    fixed_radius_nns,
)
from repro_torch.kernels import build, ops, ref
from repro_torch.models.recsys import default_youtubednn_config
from repro_torch.serving import recsys_engine as trs

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
