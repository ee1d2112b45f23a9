"""The port's kernel layer (`repro_torch.kernels`) against the JAX reference.

The same numpy inputs go through `repro`'s kernels — the jnp oracles and
the Pallas kernels in interpret mode, as `tests/test_kernels.py` runs them
— and through the port's ops on CPU tensors, which take the plain PyTorch
versions. Integer outputs must be equal bit for bit. `embedding_pool`
sums in another order than `jnp.einsum`: reordering a float32 sum of L
terms moves it by at most about L * 2**-24 of the sum of the terms'
magnitudes, so each output is held to 1e-6 of that magnitude sum (L <= 20).

The CUDA kernels themselves are held against these plain versions on the
card by `tests/test_torch_cuda.py`.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import streaming_nns as jsnn
from repro.kernels.embedding_pool import embedding_pool_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.hamming_nns import hamming_distances_pallas
from repro.kernels.int8_matmul import int8_matmul_pallas
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import streaming_nns as tsnn

POOL_RTOL = 1e-6
REPO = Path(__file__).resolve().parent.parent


def _sigs(rng, n, words):
    return rng.integers(0, 2**32, size=(n, words), dtype=np.uint32)


def _t(a):
    """numpy (uint32 signatures viewed as int32) -> CPU tensor."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.numpy()


# ---------------------------------------------------------------------------
# Hamming distances
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q,n,words", [(5, 300, 8), (9, 1030, 8), (3, 77, 2)])
def test_hamming_matches_reference(q, n, words):
    rng = np.random.default_rng(q * n)
    queries, db = _sigs(rng, q, words), _sigs(rng, n, words)
    got = _np(ops.hamming_distances(_t(queries), _t(db)))
    want_ref = np.asarray(jref.hamming_distance_ref(jnp.asarray(queries),
                                                    jnp.asarray(db)))
    want_pallas = np.asarray(hamming_distances_pallas(
        jnp.asarray(queries), jnp.asarray(db),
        block_n=jops._hamming_block_n(n), interpret=True))
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_pallas)
    assert got.dtype == np.int32


def test_popcount_covers_every_bit_pattern_class():
    words = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0xAAAAAAAA,
                      0x0F0F0F0F, 123456789], np.uint32)
    want = [bin(int(w)).count("1") for w in words]
    assert ref.popcount32(_t(words)).tolist() == want


# ---------------------------------------------------------------------------
# embedding pool
# ---------------------------------------------------------------------------
def _assert_pool_close(got, want, values, scales, ids, w):
    """|got - want| <= POOL_RTOL * (the pooled magnitudes of the terms)."""
    mag = _np(ref.embedding_pool_ref(
        _t(np.abs(values.astype(np.int16)).astype(np.int8)), _t(scales),
        _t(ids), None if w is None else _t(np.abs(w))))
    np.testing.assert_array_less(np.abs(got - want), POOL_RTOL * mag + 1e-12)


def _table(rng, n, d):
    values = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    scales = (rng.random((n, 1)) * 0.01 + 1e-4).astype(np.float32)
    return values, scales


@pytest.mark.parametrize("n,d,B,L,weighted", [
    (18, 32, 7, 1, False), (300, 32, 6, 20, True), (300, 32, 6, 20, False),
    (50, 64, 3, 5, True)])
def test_embedding_pool_matches_reference(n, d, B, L, weighted):
    rng = np.random.default_rng(n + B + L)
    values, scales = _table(rng, n, d)
    ids = rng.integers(-1, n, size=(B, L)).astype(np.int32)
    ids[0, :] = -1  # an all-padding bag pools to zero
    w = (rng.normal(size=(B, L)).astype(np.float32) if weighted else None)
    got = _np(ops.embedding_pool(_t(values), _t(scales), _t(ids),
                                 None if w is None else _t(w)))
    jargs = (jnp.asarray(values), jnp.asarray(scales), jnp.asarray(ids),
             None if w is None else jnp.asarray(w))
    want_ref = np.asarray(jref.embedding_pool_ref(*jargs))
    want_pallas = np.asarray(jops._embedding_pool_pallas(*jargs,
                                                         interpret=True))
    _assert_pool_close(got, want_ref, values, scales, ids, w)
    _assert_pool_close(got, want_pallas, values, scales, ids, w)
    np.testing.assert_array_equal(got[0], 0.0)
    if L == 1 and w is None:  # one term per output: exactly the reference
        np.testing.assert_array_equal(got, want_ref)


def test_embedding_pool_raw_pallas_call_agrees():
    rng = np.random.default_rng(5)
    values, scales = _table(rng, 40, 32)
    ids = rng.integers(-1, 40, size=(4, 3)).astype(np.int32)
    got = _np(ops.embedding_pool(_t(values), _t(scales), _t(ids)))
    want = np.asarray(embedding_pool_pallas(
        jnp.asarray(values), jnp.asarray(scales), jnp.asarray(ids),
        jnp.asarray((ids >= 0).astype(np.float32)), interpret=True))
    _assert_pool_close(got, want, values, scales, ids, None)


# ---------------------------------------------------------------------------
# streaming NNS: key helpers, merge, and all four variants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("words", [1, 2, 8])
def test_key_helpers_match_reference(words):
    assert tsnn.key_shift(words) == jsnn.key_shift(words)
    assert tsnn.big_key(words) == jsnn.big_key(words)
    assert tsnn.max_streamable_items(words) == \
        jsnn.max_streamable_items(words)
    assert tsnn.BIG_DIST == jsnn.BIG_DIST
    for block_n, sb in [(1, None), (128, 1000), (512, 4096)]:
        assert tsnn.superblock_rows(words, block_n, sb) == \
            jsnn.superblock_rows(words, block_n, sb)
    d = np.array([0, 5, 32 * words], np.int32)
    r = np.array([0, 77, tsnn.max_streamable_items(words) - 1], np.int32)
    key = tsnn.pack_key(_t(d), _t(r), words)
    np.testing.assert_array_equal(_np(key), np.asarray(
        jsnn.pack_key(jnp.asarray(d), jnp.asarray(r), words)))
    back = tsnn.unpack_key(key, words)
    np.testing.assert_array_equal(_np(back[0]), d)
    np.testing.assert_array_equal(_np(back[1]), r)


def test_superblock_rows_rejects_sub_block():
    with pytest.raises(ValueError):
        tsnn.superblock_rows(8, 512, 100)


def test_merge_buffers_match_reference():
    rng = np.random.default_rng(2)
    bufs = []
    for s in range(3):  # ascending disjoint row ranges, sorted buffers
        dist = np.sort(rng.integers(0, 6, size=(4, 5)), axis=1)
        idx = s * 100 + np.argsort(rng.random((4, 5)), axis=1)
        idx = np.take_along_axis(idx, np.argsort(dist, 1, kind="stable"), 1)
        dist[:, -1] = tsnn.BIG_DIST
        idx[:, -1] = -1
        bufs.append((idx.astype(np.int32), dist.astype(np.int32)))
    got = tsnn.merge_chunk_buffers([(_t(i), _t(d)) for i, d in bufs], 7)
    want = jsnn.merge_chunk_buffers(
        [(jnp.asarray(i), jnp.asarray(d)) for i, d in bufs], 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    with pytest.raises(ValueError):
        tsnn.merge_chunk_buffers([], 7)


def _stream_case(rng, masked, pruned, n=700, q=6, words=8, br=128):
    """Clustered DB (so pruning skips blocks) + optional mask / prune."""
    centers = _sigs(rng, n // br + 1, words)
    db = np.repeat(centers, br, axis=0)[:n].copy()
    flips = rng.integers(0, 2, size=db.shape, dtype=np.uint32) & \
        np.uint32(0x00010001)
    db ^= flips
    queries = centers[rng.integers(0, centers.shape[0], q)]
    kw = {}
    if masked:
        kw["db_mask"] = rng.random(n) < 0.8
    if pruned:
        from repro.core.nns import _prune_mask, build_block_summary

        summary = build_block_summary(db, br, db_mask=kw.get("db_mask"))
        prune, _ = _prune_mask(jnp.asarray(queries), summary, 40)
        kw["prune_blocks"] = np.asarray(prune)
        kw["prune_block_rows"] = br
        assert kw["prune_blocks"].any()  # the case really prunes
    return queries, db, kw


@pytest.mark.parametrize("masked,pruned,superblock", [
    (False, False, None), (True, False, None), (False, True, None),
    (True, True, None), (True, True, 256)])
def test_streaming_nns_matches_reference(masked, pruned, superblock):
    rng = np.random.default_rng(int(masked) * 2 + int(pruned))
    queries, db, kw = _stream_case(rng, masked, pruned)
    radius, K = 40, 16
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    got = ops.streaming_nns(_t(queries), _t(db), radius=radius,
                            max_candidates=K, scan_block=96, n_valid=650,
                            superblock=superblock, **tkw)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jq, jdb = jnp.asarray(queries), jnp.asarray(db)
    want_ref = jref.streaming_nns_ref(jq, jdb, radius, K, scan_block=96,
                                      n_valid=650, superblock=superblock,
                                      **jkw)
    want_pallas = jops._streaming_nns_pallas(
        jq, jdb, radius=radius, max_candidates=K, scan_block=128,
        n_valid=650, superblock=superblock, interpret=True, **jkw)
    for g, wr, wp in zip(got, want_ref, want_pallas):
        np.testing.assert_array_equal(_np(g), np.asarray(wr))
        np.testing.assert_array_equal(_np(g), np.asarray(wp))
    assert int(got[2].sum()) > 0  # the case has matches


def test_split_layout_aligns_and_covers():
    for n in (1, 300, 4096, 1 << 20, (1 << 20) + 5, (1 << 24) + 5):
        for q in (1, 16, 256, 1 << 16):
            for pbr in (None, 128, 4096):
                for sb in (None, 2048):
                    rows, splits = tsnn.split_layout(
                        n, q, 132, prune_block_rows=pbr, superblock=sb)
                    align = pbr or tsnn.CUDA_SPLIT_ALIGN
                    assert rows % align == 0 and rows >= align
                    assert splits * rows >= n > (splits - 1) * rows
                    assert rows <= tsnn.CUDA_MAX_SPLIT_ROWS
                    if sb is not None:
                        assert rows <= max(align, sb)


# ---------------------------------------------------------------------------
# the +-1 arithmetic of the streaming kernel's tensor-core scan
# ---------------------------------------------------------------------------
def _pm1_expand(sigs: np.ndarray) -> np.ndarray:
    """(n, words) uint32 -> (n, 32 words) int8, the kernel's expansion:
    byte 32 w + 4 j + b is -1 where bit j + 8 b of word w is set, else +1
    (`pm1` in csrc/streaming_nns.cu)."""
    n, words = sigs.shape
    out = np.empty((n, words, 8, 4), np.int8)
    for j in range(8):
        for b in range(4):
            bit = (sigs >> np.uint32(j + 8 * b)) & np.uint32(1)
            out[:, :, j, b] = 1 - 2 * bit.astype(np.int8)
    return out.reshape(n, 32 * words)


def _pm1_dot(queries: np.ndarray, db: np.ndarray) -> np.ndarray:
    """The int32 product of the expanded operands, as the s8 `mma` sums."""
    return (_pm1_expand(queries).astype(np.int32)
            @ _pm1_expand(db).astype(np.int32).T)


def _bit_pattern_sigs(rng, n, words):
    special = np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0x80000001,
                        0xAAAAAAAA, 0x55555555, 1], np.uint32)
    sigs = _sigs(rng, n, words)
    sigs[:len(special)] = special[:, None]  # whole rows of one pattern
    sigs[len(special):2 * len(special)] = rng.choice(special, (len(special),
                                                               words))
    return sigs


@pytest.mark.parametrize("words", range(1, 9))
def test_pm1_product_gives_the_hamming_distance(words):
    rng = np.random.default_rng(100 + words)
    queries = _bit_pattern_sigs(rng, 20, words)
    db = _bit_pattern_sigs(rng, 70, words)
    dot = _pm1_dot(queries, db)
    assert ((32 * words - dot) % 2 == 0).all()
    dist = (32 * words - dot) // 2
    np.testing.assert_array_equal(
        dist, _np(ref.hamming_distance_ref(_t(queries), _t(db))))
    np.testing.assert_array_equal(dist, np.asarray(jref.hamming_distance_ref(
        jnp.asarray(queries), jnp.asarray(db))))
    np.testing.assert_array_equal(dist, np.asarray(hamming_distances_pallas(
        jnp.asarray(queries), jnp.asarray(db),
        block_n=jops._hamming_block_n(db.shape[0]), interpret=True)))
    assert dist[0, 1] == 32 * words  # all zeros vs all ones


@pytest.mark.parametrize("words", [1, 3, 8])
def test_pm1_threshold_is_the_radius_test(words):
    rng = np.random.default_rng(words)
    queries = _bit_pattern_sigs(rng, 20, words)
    db = _bit_pattern_sigs(rng, 40, words)
    dot = _pm1_dot(queries, db)
    dist = _np(ref.hamming_distance_ref(_t(queries), _t(db)))
    for r in range(-1, 32 * words + 2):
        np.testing.assert_array_equal(dot >= 32 * words - 2 * r, dist <= r)


def _hamming_tiles(queries: np.ndarray, db: np.ndarray):
    """The dense Hamming kernel (`csrc/hamming.cu`) emulated on the CPU:
    64-query x 64-row tiles of the +-1 product (rows and queries past the
    ends expanded from 0 words), d = (32 w - acc) / 2, each warp's 16 x 64
    distances staged, then stored as one 4-word chunk a lane into an output
    whose row stride is n rounded up to 4 words. Returns the output buffer
    (q, ld) and how often each of its words was written."""
    q, words = queries.shape
    n = db.shape[0]
    ld = -(-n // 4) * 4
    out = np.full((q, ld), -7, np.int32)
    written = np.zeros(out.shape, np.int32)
    qt, nt = -(-q // 64), -(-n // 64)
    a = _pm1_expand(np.concatenate(
        [queries, np.zeros((qt * 64 - q, words), np.uint32)]))
    b = _pm1_expand(np.concatenate(
        [db, np.zeros((nt * 64 - n, words), np.uint32)]))
    flat = out.reshape(-1)
    for t in range(qt):
        for tile in range(nt):
            acc = (a[64 * t:64 * (t + 1)].astype(np.int32)
                   @ b[64 * tile:64 * (tile + 1)].astype(np.int32).T)
            assert ((32 * words - acc) % 2 == 0).all()
            dist = (32 * words - acc) >> 1
            for rr in range(64):  # 4 warps x 16 staged rows
                qi = 64 * t + rr
                if qi >= q:
                    break
                for lane in range(16):  # a half-warp, 16 bytes a lane
                    c = 64 * tile + 4 * lane
                    if c >= ld:
                        continue
                    dst = qi * ld + c
                    assert dst % 4 == 0  # a 16-byte aligned chunk
                    flat[dst:dst + 4] = dist[rr, 4 * lane:4 * lane + 4]
                    written.reshape(-1)[dst:dst + 4] += 1
    return out, written


@pytest.mark.parametrize("words", range(1, 9))
def test_hamming_tensor_core_tiles_match_pallas(words):
    """Ragged q and n around the kernel's 64 x 64 tile, at every word
    count, with n off a multiple of 4 (padded rows) and on one: every word
    of the (q, n) result is written once, the padding at most once and
    nothing past it, and the result equals the Pallas kernel in interpret
    mode."""
    rng = np.random.default_rng(200 + words)
    q, n = (70, 130) if words % 2 else (65, 67)
    queries = _bit_pattern_sigs(rng, q, words)
    db = _bit_pattern_sigs(rng, n, words)
    for rows in (n, 64):
        want = np.asarray(hamming_distances_pallas(
            jnp.asarray(queries), jnp.asarray(db[:rows]),
            block_n=jops._hamming_block_n(rows), interpret=True))
        got, written = _hamming_tiles(queries, db[:rows])
        np.testing.assert_array_equal(got[:, :rows], want)
        assert (written[:, :rows] == 1).all()
        assert (written[:, rows:] <= 1).all()


# ---------------------------------------------------------------------------
# routing, build and import hygiene (no GPU needed)
# ---------------------------------------------------------------------------
def test_override_values_are_checked(monkeypatch):
    x = torch.zeros((1, 8), dtype=torch.int32)
    monkeypatch.setenv("REPRO_TORCH_HAMMING_DISTANCES", "torch")
    assert not ops.use_kernel("hamming_distances", x)
    monkeypatch.setenv("REPRO_TORCH_HAMMING_DISTANCES", "pallas")
    with pytest.raises(ValueError):
        ops.hamming_distances(x, x)


def test_pool_plan_checks_its_segments():
    """A grouped-pool plan checks its tables once, when it is made: dtypes,
    scale and hot-row shapes, the mode, the column; 1 to 8 segments."""
    v = torch.zeros((5, 32), dtype=torch.int8)
    sc = torch.ones((5, 1))
    plan = ops.PoolPlan([ops.PoolSegment(v, sc, column=4),
                         ops.PoolSegment(v, sc, mode="rows", column=40,
                                         counted=True)])
    assert plan.width == 72 and plan.counted
    hot = torch.zeros(3, dtype=torch.int32)
    for bad in (ops.PoolSegment(v.float(), sc), ops.PoolSegment(v, sc[:4]),
                ops.PoolSegment(v, sc, mode="max"),
                ops.PoolSegment(v, sc, column=-1),
                ops.PoolSegment(v, sc, hot_ids=hot,
                                hot_rows=torch.zeros(3, 16))):
        with pytest.raises(ValueError):
            ops.PoolPlan([bad])
    for n in (0, 9):
        with pytest.raises(ValueError):
            ops.PoolPlan([ops.PoolSegment(v, sc)] * n)


def test_cpu_tensors_take_the_plain_versions():
    build.reset_launches()
    x = torch.zeros((2, 8), dtype=torch.int32)
    ops.hamming_distances(x, x)
    ops.streaming_nns(x, x, radius=3, max_candidates=2)
    assert set(build.launch_counts().values()) == {0}


def test_build_compiles_each_source_once_per_content(tmp_path, monkeypatch):
    """A fake `nvcc` stands in for the real one: every source compiles in
    its own process into a content-addressed library, an unchanged source
    is not rebuilt, and a failing compile raises with its log."""
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    log = tmp_path / "calls"
    fake.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {log}\n"
                    "while [ $# -gt 1 ]; do [ \"$1\" = -o ] && out=$2; "
                    "shift; done\n"
                    "[ -n \"$FAIL\" ] && { echo boom; exit 3; }\n"
                    "touch \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    kernels = [build.CudaKernel(k.name, k.source.name, k.argtypes)
               for k in build.KERNELS]
    monkeypatch.setattr(build.CudaKernel, "_load", lambda self: None)
    build.build_all(kernels)
    calls = log.read_text().splitlines()
    assert len(calls) == len(kernels)
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    for k in kernels:
        path = k.library_path()
        assert path.exists() and path.parent == tmp_path / "out"
        assert path.name.startswith(k.source.stem + "-")
    build.build_all(kernels)  # libraries exist: nothing recompiles
    assert len(log.read_text().splitlines()) == len(kernels)
    monkeypatch.setenv("FAIL", "1")
    for k in kernels:
        k.library_path().unlink()
    with pytest.raises(RuntimeError, match="boom"):
        build.build_all(kernels[:1])
    assert list((tmp_path / "out").iterdir()) == []  # no partial library


def test_sources_carry_their_notes():
    for k in build.KERNELS:
        text = k.source.read_text()
        assert k.source.exists() and f"REPRO_API int {k.name}(" in text
        for note in ("Replaces:", "Bound on the H100:", "Design:"):
            assert note in text, (k.source.name, note)


def test_import_builds_nothing_and_needs_no_jax():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.kernels.ops, repro_torch.serving.recsys_engine, "
            "repro_torch.serving.engine, repro_torch.serving.kv_cache, "
            "repro_torch.launch.serve, repro_torch.configs.registry, "
            "repro_torch.configs.qwen3_8b, repro_torch.configs.qwen2_5_3b, "
            "repro_torch.configs.chatglm3_6b, repro_torch.serving, "
            "repro_torch.serving.batcher, repro_torch.serving.async_server, "
            "repro_torch.serving.frontend, repro_torch.serving.server, "
            "repro_torch.serving.load_gen, repro_torch.obs, "
            "repro_torch.obs.registry, repro_torch.obs.tracing, "
            "repro_torch.core.cost_model, repro_torch.core.mapping, "
            "repro_torch.data.synthetic\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'triton')]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "REPRO_TORCH_BUILD_DIR": "/nonexistent/never-created"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


# ---------------------------------------------------------------------------
# flash attention and int8 matmul (the LM side)
# ---------------------------------------------------------------------------
FLASH_CASES = [(2, 128, 128, 64, True), (1, 64, 192, 64, True),
               (2, 100, 100, 32, False)]  # as tests/test_kernels.py


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,sq,sk,d,causal", FLASH_CASES)
def test_flash_ref_matches_pallas_kernel(bh, sq, sk, d, causal, dtype):
    """The plain version against the Pallas kernel in interpret mode, both
    in the working dtype: 2e-5 in float32 (sums in another order), 2e-2
    in bfloat16 (the tolerance `tests/test_kernels.py` holds the kernel to;
    the outputs round to bf16)."""
    rng = np.random.default_rng(bh * sq + sk + d)
    q, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32)
               for s in (sq, sk, sk))
    q_offset = sk - sq if causal else 0
    jdt = jnp.dtype(dtype)
    want = flash_attention_pallas(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), causal=causal,
        block_q=64, block_k=64, q_offset=q_offset, interpret=True)
    tdt = getattr(torch, dtype)
    got = ops.flash_attention_bhsd(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal,
        q_offset=q_offset)
    assert got.dtype == tdt and got.shape == (bh, sq, d)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def _tensor_core_flash(q, k, v, *, causal, scale, q_offset, block_k=64):
    """The rounding of the bf16 tensor-core kernel (`flash_attention.cu`),
    in plain PyTorch on the CPU: 64-key tiles, online softmax in float32
    with exp2 and scale * log2(e) folded in, masked probabilities exactly
    0, P rounded to bf16 before P V, float32 accumulation, out in bf16."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale_log2 = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    rows = torch.arange(sq)[:, None] + q_offset
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    for k0 in range(0, sk, block_k):
        kt, vt = k[:, k0:k0 + block_k].float(), v[:, k0:k0 + block_k].float()
        cols = k0 + torch.arange(kt.shape[1])[None, :]
        valid = (cols <= rows) if causal else torch.ones_like(cols, dtype=bool)
        x = torch.where(valid, (q.float() @ kt.transpose(1, 2)) * scale_log2,
                        -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(valid, torch.exp2(x - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vt
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("bh,sq,sk,d,causal,q_offset", [
    (bh, sq, sk, d, causal, sk - sq if causal else 0)
    for bh, sq, sk, d, causal in FLASH_CASES] + [(2, 80, 100, 16, True, -20)])
def test_tensor_core_rounding_stays_within_the_bf16_tolerance(
        bh, sq, sk, d, causal, q_offset):
    """The bf16 kernel's own rounding (P in bf16 before P V), emulated on
    the CPU, against the Pallas kernel in interpret mode at the bf16
    tolerance, 2e-2: the design's numerics hold without a card."""
    rng = np.random.default_rng(bh * sq + sk + d + 1)
    q, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32)
               for s in (sq, sk, sk))
    want = flash_attention_pallas(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        causal=causal, block_q=64, block_k=64, q_offset=q_offset,
        interpret=True)
    got = _tensor_core_flash(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=causal, scale=d**-0.5, q_offset=q_offset)
    if q_offset < 0:  # rows with no valid key: exactly 0, as the kernel
        assert bool((got[:, :-q_offset] == 0).all())
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_flash_ref_row_without_a_valid_key_is_zero():
    """q_offset < 0 leaves the first rows with no key at or before them:
    the kernel's -1e30 masking and clamped normalizer give 0, not NaN."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 16))
                                .astype(np.float32)) for _ in range(3))
    got = ref.flash_attention_ref(q, k, v, causal=True, q_offset=-3)
    assert bool(torch.isfinite(got).all())
    assert bool((got[0, :3] == 0).all()) and bool((got[0, 3:] != 0).any())


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 7),
                                             (False, 0)])
def test_attention_refs_match_reference(causal, q_offset):
    """attention_ref and blocked_attention_ref on (b, h, s, d) against the
    jnp oracles, 2e-5 (float32 sums in another order)."""
    rng = np.random.default_rng(q_offset)
    q = rng.standard_normal((2, 3, 37, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 3, 44, 16)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=causal, q_offset=q_offset)
    for got, want in (
            (ref.attention_ref(tq, tk, tv, **kw),
             jref.attention_ref(jq, jk, jv, **kw)),
            (ref.blocked_attention_ref(tq, tk, tv, block_k=16, **kw),
             jref.blocked_attention_ref(jq, jk, jv, block_k=16, **kw))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def test_flash_attention_op_matches_reference_op():
    """ops.flash_attention on (b, h, s, d) CPU tensors (the kernel's plain
    version) against the reference's public op (its blocked oracle on the
    CPU), 2e-5."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 4, 50, 32)).astype(np.float32)
               for _ in range(3))
    want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("m,k,n", [(8, 32, 16), (128, 256, 128),
                                   (100, 130, 50)])
def test_int8_matmul_equals_pallas_kernel(m, k, n):
    """Bit for bit: the integer accumulator is exact on both sides and the
    two scale multiplies round in the same order."""
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sx = (np.abs(rng.standard_normal((m, 1))) + 0.01).astype(np.float32)
    sw = (np.abs(rng.standard_normal((1, n))) + 0.01).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, w, sx, sw)]
    want = np.asarray(int8_matmul_pallas(*args, block_m=64, block_n=64,
                                         block_k=64, interpret=True))
    got = ops.int8_matmul(*(torch.from_numpy(a) for a in (x, w, sx, sw)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.int8_matmul_ref(*args)))


def test_lm_ops_on_cpu_tensors_launch_nothing():
    build.reset_launches()
    q = torch.zeros((1, 2, 8, 16))
    ops.flash_attention(q, q, q)
    x = torch.zeros((4, 8), dtype=torch.int8)
    ops.int8_matmul(x, x.T.contiguous(), torch.ones(4, 1), torch.ones(1, 4))
    assert set(build.launch_counts().values()) == {0}
