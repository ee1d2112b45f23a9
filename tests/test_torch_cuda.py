"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports neither JAX nor the reference package, so it also runs
where only PyTorch is installed; from the repository root:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` because `tests/conftest.py` imports JAX.) The plain
versions are themselves held against the JAX reference on the CPU by
`tests/test_torch_kernels.py`, `tests/test_torch_core.py` and
`tests/test_torch_engine.py`. Integer outputs must be equal; the pool's
floats are held to 1e-6 of the pooled magnitudes, as there.
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


@pytest.mark.parametrize("masked,pruned,superblock", [
    (False, False, None), (True, False, None), (False, True, None),
    (True, True, None), (False, False, 2048), (True, True, 256)])
@pytest.mark.parametrize("k", [1, 50, 128])
def test_streaming_nns_equals_plain(cuda, masked, pruned, superblock, k):
    rng = np.random.default_rng(11)
    queries, db = _clustered(rng, 9000, 37, 8, cuda)
    kw = {}
    if masked:
        kw["db_mask"] = torch.rand(db.shape[0], device=cuda) < 0.8
    if pruned:
        summary = build_block_summary(db, 128, db_mask=kw.get("db_mask"))
        kw["prune_blocks"], _ = _prune_mask(queries, summary, 40)
        kw["prune_block_rows"] = 128
        assert bool(kw["prune_blocks"].any())
    before = build.STREAMING_NNS.launches
    got = ops.streaming_nns(queries, db, radius=40, max_candidates=k,
                            n_valid=8900, superblock=superblock, **kw)
    torch.cuda.synchronize()
    assert build.STREAMING_NNS.launches == before + 1
    want = ref.streaming_nns_ref(queries, db, 40, k, n_valid=8900,
                                 superblock=superblock, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].sum()) > 0


@pytest.mark.parametrize("case", ["n_valid_zero", "duplicates",
                                  "radius_overflow", "empty_db"])
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
    assert counts["embedding_pool"] == 1
    assert counts["hamming_distances" if scan_block is None
                  else "streaming_nns"] == 1
    with _plain("hamming_distances", "embedding_pool", "streaming_nns"):
        plain = gpu.serve(batch)
    assert build.launch_counts() == counts  # the plain path launched none
    assert torch.equal(got.items, plain.items)
    assert torch.equal(got.nns.indices, plain.nns.indices)
    assert got.stats.as_dict() == cpu.serve(batch).stats.as_dict()
