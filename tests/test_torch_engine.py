"""The port's frozen serve step against the JAX reference engine, on the CPU.

A `repro` engine is built from `init_youtubednn` parameters with the
default MovieLens config (cut to 600 items) and hot caches pinned by a
Zipf histogram; its arrays are exported with `np.asarray` and loaded into a
`repro_torch` engine (`convert.engine_from_arrays`). The same request batch
(with padding rows and -1 padded histories) is served by both, once on the
dense plan and once on the pruned streaming plan (`scan_block=128`).

Checked: cache counters equal; user embeddings within 1e-6 relative (the
same float32 ops, summed in another order); given the reference's query
signatures, NNS candidates, distances, counts and `blocks_touched` equal
bit for bit; CTRs within 1e-6; final ids equal wherever the CTR gaps that
decide them exceed that tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lsh import lsh_signature as jlsh_signature
from repro.models import recsys as jrs
from repro.serving import RecSysEngine as JaxEngine
from repro.serving.recsys_engine import _features as jax_features
from repro_torch.convert import engine_from_arrays, params_from_numpy
from repro_torch.core.lsh import lsh_signature
from repro_torch.serving import recsys_engine as trs
from repro_torch.serving.recsys_engine import RecSysEngine

N_ITEMS = 600
B = 24
FLOAT_RTOL = 1e-6


def export(engine) -> dict:
    """Everything `engine_from_arrays` needs, as numpy, from a built
    reference engine."""
    def pair(q):
        return (np.asarray(q.values), np.asarray(q.scales))

    def hot(h):
        return (np.asarray(h.hot_ids), np.asarray(h.hot_rows))

    bs = engine.block_summary
    return dict(
        cfg=engine.cfg, params=jax.tree.map(np.asarray, engine.params),
        tables_q={k: pair(v) for k, v in engine.tables_q.items()},
        item_table_q=pair(engine.item_table_q),
        genre_table_q=pair(engine.genre_table_q),
        item_sigs=np.asarray(engine.item_sigs),
        lsh_proj=np.asarray(engine.lsh_proj), item_hot=hot(engine.item_hot),
        uiet_hot={k: hot(v) for k, v in engine.uiet_hot.items()},
        block_summary={**{f: np.asarray(getattr(bs, f)) for f in (
            "or_sigs", "and_sigs", "min_pc", "max_pc", "n_alive")},
            "block_rows": bs.block_rows},
        radius=engine.radius, n_candidates=engine.n_candidates,
        top_k=engine.top_k, scan_block=engine.scan_block, prune=engine.prune)


@pytest.fixture(scope="module")
def built():
    cfg = jrs.default_youtubednn_config()._replace(n_items=N_ITEMS)
    params = jrs.init_youtubednn(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)
    freqs = np.bincount(rng.zipf(1.3, 5000) % N_ITEMS, minlength=N_ITEMS)
    jeng = JaxEngine.build(params, cfg, hot_rows=64, item_freqs=freqs,
                           uiet_freqs={"user_id": np.bincount(
                               rng.integers(0, 6040, 3000), minlength=6040)})
    batch = {k: rng.integers(0, c, B).astype(np.int32)
             for k, c in cfg.user_features.items()}
    hist = (rng.zipf(1.3, (B, cfg.history_len)) % N_ITEMS).astype(np.int32)
    hist[np.arange(cfg.history_len)[None] >= rng.integers(
        1, cfg.history_len + 1, B)[:, None]] = -1
    batch.update(history=hist,
                 genre=rng.integers(0, 18, B).astype(np.int32),
                 valid=np.arange(B) < B - 3)  # three padding rows
    return jeng, export(jeng), params, batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _eq(got, want):
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)


def _decided_prefix(scores, tol):
    """Per row: how many leading top-k slots are decided by gaps > tol
    (a slot is decided when its score beats the next one by more)."""
    s = np.where(np.isfinite(scores), scores, -1.0)
    gaps = s[:, :-1] - s[:, 1:]
    decided = np.cumprod(gaps > tol, axis=1)
    return decided.sum(1)


@pytest.mark.parametrize("plan", ["dense", "pruned_streaming"])
def test_serve_step_matches_reference(built, plan):
    jeng, arrays, _, batch = built
    if plan == "pruned_streaming":
        jeng = dataclasses.replace(jeng, scan_block=128)
        arrays = {**arrays, "scan_block": 128}
    teng = engine_from_arrays(**arrays, device="cpu")
    jb = _jbatch(batch)

    want = jeng.serve(jb)
    got = teng.serve(batch)
    assert got.stats.as_dict() == want.stats.as_dict()
    assert got.stats.as_dict()["hits"] > 0  # the caches really served rows
    assert got.cost is None

    u_want = np.asarray(jax.jit(jax_features)(jeng, jb)[0])
    u_got = teng.user_embedding(batch)
    np.testing.assert_allclose(u_got.numpy(), u_want, rtol=FLOAT_RTOL,
                               atol=1e-7)
    q_want = jlsh_signature(jnp.asarray(u_want), jeng.lsh_proj)
    q_got = lsh_signature(u_got, teng.lsh_proj)
    agree = float((q_got.numpy() == np.asarray(q_want).view(np.int32))
                  .mean())
    assert agree > 0.99, agree  # only bits with |u @ proj| ~ 0 may flip

    # given the reference's query signatures, the NNS is bit-equal
    nns = trs._nns(teng, torch.from_numpy(np.array(q_want).view(np.int32)))
    for f in ("indices", "distances", "counts", "blocks_touched"):
        if getattr(want.nns, f) is None:
            assert getattr(nns, f) is None
        else:
            _eq(getattr(nns, f), getattr(want.nns, f))
    if plan == "pruned_streaming":
        assert nns.blocks_touched is not None
    assert int((want.nns.counts > 0).sum()) > B // 2  # real candidates

    # rank the reference's candidates: CTRs within tolerance, and the
    # final ids equal wherever the CTR gaps decide them
    cand = np.asarray(want.nns.indices)
    top = teng.rank_stage(batch, cand)
    # all candidates ranked: the top-k prefix is the served top-k
    full = dataclasses.replace(jeng, top_k=jeng.n_candidates)
    jtop = full.rank_stage(jb, jnp.asarray(cand))
    all_scores = np.asarray(jtop.scores)
    np.testing.assert_allclose(top.scores.numpy(),
                               all_scores[:, :jeng.top_k], rtol=FLOAT_RTOL,
                               atol=1e-7)
    _eq(top.counts, jtop.counts)
    n_decided = _decided_prefix(all_scores, 2e-6)
    same_sigs = (q_got.numpy() == np.asarray(q_want).view(np.int32)).all(1)
    items_got, items_want = got.items.numpy(), np.asarray(want.items)
    checked = 0
    for r in range(B):
        k = min(int(n_decided[r]), jeng.top_k)
        if same_sigs[r]:
            np.testing.assert_array_equal(items_got[r, :k],
                                          items_want[r, :k])
            checked += k
    assert checked > B * jeng.top_k // 2


def test_build_on_cpu_matches_reference_build(built):
    """`RecSysEngine.build` from the reference's parameters and projection
    quantizes the same tables, pins the same rows and signs the items."""
    jeng, arrays, params, _ = built
    rng = np.random.default_rng(0)
    freqs = np.bincount(rng.zipf(1.3, 5000) % N_ITEMS, minlength=N_ITEMS)
    teng = RecSysEngine.build(
        params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        arrays["cfg"], lsh_proj=torch.from_numpy(np.array(jeng.lsh_proj)),
        hot_rows=64, item_freqs=freqs, uiet_freqs={"user_id": np.bincount(
            rng.integers(0, 6040, 3000), minlength=6040)}, device="cpu")
    _eq(teng.item_table_q.values, jeng.item_table_q.values)
    _eq(teng.item_table_q.scales, jeng.item_table_q.scales)
    for name in jeng.tables_q:
        _eq(teng.tables_q[name].values, jeng.tables_q[name].values)
        _eq(teng.uiet_hot[name].hot_ids, jeng.uiet_hot[name].hot_ids)
    _eq(teng.item_hot.hot_ids, jeng.item_hot.hot_ids)
    _eq(teng.item_hot.hot_rows, jeng.item_hot.hot_rows)
    sig_agree = float((teng.item_sigs.numpy() ==
                       np.asarray(jeng.item_sigs).view(np.int32)).mean())
    assert sig_agree > 0.99, sig_agree
    assert teng.block_summary.n_blocks == jeng.block_summary.n_blocks
    assert teng.device == torch.device("cpu")


def test_entry_points_default_to_cuda(built):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _, arrays, _, _ = built
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_from_arrays(**arrays)
