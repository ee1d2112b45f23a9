"""Train-while-serve in the port: `OnlineTrainer` and the shadow oracle,
on the CPU.

The contracts of the reference's `tests/test_online.py`, reproduced on
the port over an engine exported from `repro` (90 items, radius 112, 16
candidates, top 5, 32 hot rows): after ``fold(); refresh_dense()`` the
live engine serves bit for bit what a cold rebuild of the trainer's
parameters serves (`rebuild_from_params`) and what the catalog's own
table-level oracle serves, so the shadow HR gap is exactly 0; a
divergence is seen and gates; staleness is counted per landed batch;
folds follow their cadence; a publication keeps the engine's structure;
a concurrent front-end serves while a training thread folds and compacts.

Added for the port: a step without a fold changes nothing an engine
serves (the trainer's parameters are its own and AdamW is out of place),
and the same reference parameters and batches through both packages'
trainers fold the same rows and end within the training tolerance of
`tests/test_torch_training.py` (parameters within 1e-6 in all but 0.1% of
entries, within 1e-5 everywhere). Every thread join and ticket wait has a
timeout.
"""
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.models import recsys as jrs
from repro.serving import LiveCatalog as JLiveCatalog
from repro.serving import OnlineTrainer as JOnlineTrainer
from repro.serving import RecSysEngine as JaxEngine
from repro_torch.checkpoint.checkpointer import _leaves
from repro_torch.convert import engine_from_arrays
from repro_torch.data import synthetic
from repro_torch.models import recsys as trs
from repro_torch.serving import (
    LiveCatalog,
    OnlineTrainer,
    ShadowHarness,
    make_server,
    rebuild_from_params,
)
from repro_torch.utils import tree_leaves
from test_torch_engine import export

WAIT_S = 60.0


@pytest.fixture(scope="module")
def world():
    data = jsyn.make_movielens(n_users=120, n_items=90, history_len=6)
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
    tcfg = trs.YoutubeDNNConfig(**{**cfg._asdict(), "user_features": dict(
        cfg.user_features)})
    return teng, data, tcfg, jax.tree.map(np.asarray, params), jeng, cfg


def _trainer(world, **kw):
    engine, data, tcfg, params = world[:4]
    cat = LiveCatalog(engine, delta_capacity=engine.cfg.n_items)
    return OnlineTrainer(cat, tcfg, params, **kw), data


def _queries(data, n=20):
    return list(synthetic.serving_queries(data, np.arange(n) % 60))


def _serve(engine, queries):
    out = make_server(engine, "sync", max_batch=8).serve_many(queries)
    return (np.stack([o.items for o in out]),
            np.stack([o.scores for o in out]))


def _batches(data, n, seed=1, batch=64):
    return list(synthetic.movielens_batches(data, batch, n, seed=seed))


def _same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


# ---------------------------------------------------------------------------
# the fold/refresh contract: live == cold rebuild, bit for bit
# ---------------------------------------------------------------------------
def test_fold_refresh_bitmatches_cold_rebuild(world):
    trainer, data = _trainer(world, fold_every=0)
    for b in _batches(data, 5):
        trainer.step(b)
    trainer.fold()
    trainer.refresh_dense()
    queries = _queries(data)
    live = _serve(trainer.catalog.engine, queries)
    _same(live, _serve(rebuild_from_params(trainer.catalog.engine,
                                           trainer.params), queries))
    # ... and against the catalog's own table-level oracle
    _same(live, _serve(trainer.catalog.rebuild_reference(), queries))


def test_shadow_checkpoint_gap_is_zero(world):
    """The fold and refresh transforms are the build's own, so live and
    cold-rebuilt HR are identical and the probe agrees everywhere."""
    trainer, data = _trainer(world, fold_every=2)
    shadow = ShadowHarness(trainer, data, k=5, tol=0.01, probe_batch=64)
    for b in _batches(data, 6):
        trainer.step(b)
    rec = shadow.checkpoint()
    assert rec.gap == 0.0
    assert rec.agree_frac == 1.0
    assert rec.hr_live == rec.hr_ref
    assert rec.step == 6 and rec.staleness_ms > 0.0
    assert shadow.records == [rec]
    # a second checkpoint with no steps between still holds
    assert shadow.checkpoint().gap == 0.0


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_shadow_gap_is_zero_in_every_hr_mode(world, mode):
    trainer, data = _trainer(world, fold_every=1, compact_every=2)
    for b in _batches(data, 3):
        trainer.step(b)
    rec = ShadowHarness(trainer, data, k=5, mode=mode,
                        probe_batch=32).checkpoint()
    assert rec.gap == 0.0 and rec.agree_frac == 1.0


def test_shadow_detects_divergence_and_gates(world):
    """A live engine that really diverges from the trainer's parameters is
    visible to the harness, and the tolerance check raises."""
    trainer, data = _trainer(world, fold_every=0)
    for b in _batches(data, 3):
        trainer.step(b)
    trainer.fold()
    trainer.refresh_dense()
    # corrupt the live catalog behind the trainer's back: the next fold
    # sees no trainer-side change, so serving stays wrong while the cold
    # rebuild of the (honest) parameters does not
    rng = np.random.default_rng(0)
    d = trainer._last_folded.shape[1]
    trainer.catalog.upsert(np.arange(30),
                           rng.normal(size=(30, d)).astype(np.float32) * 5)
    rec = ShadowHarness(trainer, data, k=5, tol=1.0,
                        probe_batch=64).checkpoint()
    assert rec.agree_frac < 1.0  # the probe sees the divergence
    # the gate records the failing checkpoint, then raises
    shadow = ShadowHarness(trainer, data, k=5, tol=-1.0, probe_batch=0)
    with pytest.raises(AssertionError, match="exceeds tol"):
        shadow.checkpoint()
    assert len(shadow.records) == 1


# ---------------------------------------------------------------------------
# staleness accounting: landed vs visible is measured, not assumed
# ---------------------------------------------------------------------------
def test_staleness_counters(world):
    trainer, data = _trainer(world, fold_every=0)
    for i, b in enumerate(_batches(data, 3)):
        trainer.step(b)
        assert trainer.updates_landed == i + 1
        assert trainer.updates_visible == 0
        assert trainer.updates_pending == i + 1
    assert trainer.staleness_ms == []
    n = trainer.fold()
    assert n == 90  # full softmax moves every item row
    assert trainer.updates_visible == 3 and trainer.updates_pending == 0
    assert len(trainer.staleness_ms) == 3
    assert all(ms >= 0.0 for ms in trainer.staleness_ms)
    # the first-landed batch waited longest
    assert trainer.staleness_ms == sorted(trainer.staleness_ms,
                                          reverse=True)
    st = trainer.stats()
    assert st["updates_landed"] == 3 and st["updates_pending"] == 0
    assert st["staleness_ms_mean"] > 0.0
    assert st["staleness_ms_p95"] >= st["staleness_ms_mean"] * 0.5
    assert np.isfinite(st["last_loss"])


def test_fold_cadence_and_noop(world):
    trainer, data = _trainer(world, fold_every=2)
    bs = _batches(data, 4)
    trainer.step(bs[0])
    assert trainer.n_folds == 0 and trainer.updates_pending == 1
    trainer.step(bs[1])  # cadence hit: auto-fold
    assert trainer.n_folds == 1 and trainer.updates_pending == 0
    # a fold with nothing pending publishes nothing
    engine = trainer.catalog.engine
    assert trainer.fold() == 0
    assert trainer.catalog.engine is engine
    trainer.step(bs[2])
    trainer.step(bs[3])
    assert trainer.n_folds == 3 and trainer.updates_visible == 4
    assert trainer.rows_folded == 2 * 90


def test_refresh_preserves_structure(world):
    """Fold and refresh keep the engine's fields, shapes and dtypes."""
    trainer, data = _trainer(world, fold_every=1)

    def layout(engine):
        return [(path, tuple(t.shape), t.dtype)
                for path, t in _leaves(engine)]

    want = layout(trainer.catalog.engine)
    for b in _batches(data, 2):
        trainer.step(b)
    trainer.refresh_dense()
    assert layout(trainer.catalog.engine) == want


def test_online_collector_rides_the_registry(world):
    engine = world[0]
    cat = LiveCatalog(engine, delta_capacity=engine.cfg.n_items)
    server = make_server(cat.engine, "sync", max_batch=8)
    cat.attach(server)
    trainer = OnlineTrainer(cat, world[2], world[3], fold_every=1)
    for b in _batches(world[1], 2):
        trainer.step(b)
    snap = server.registry.snapshot()
    assert snap["online.steps"] == 2 and snap["online.folds"] == 2
    assert snap["online.rows_folded"] == 180
    assert snap["online.staleness_ms.count"] == 2


# ---------------------------------------------------------------------------
# the trainer's parameters are its own
# ---------------------------------------------------------------------------
def test_step_without_fold_changes_nothing_served(world):
    """One step with no fold leaves the published engine, its parameters
    and what an attached server serves exactly as they were."""
    engine, data = world[0], world[1]
    cat = LiveCatalog(engine, delta_capacity=engine.cfg.n_items)
    server = make_server(cat.engine, "sync", max_batch=8)
    cat.attach(server)
    trainer = OnlineTrainer(cat, world[2], world[3], fold_every=0)
    queries = _queries(data)
    published = cat.engine
    params_before = [t.clone() for t in tree_leaves(published.params)]
    served_before = server.serve_many(queries)
    ptrs = {t.data_ptr() for t in tree_leaves(published.params)}
    assert not ptrs & {t.data_ptr() for t in tree_leaves(trainer.params)}
    trainer.step(_batches(data, 1)[0])
    assert cat.engine is published
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(published.params), params_before))
    served_after = server.serve_many(queries)
    for a, b in zip(served_after, served_before):
        np.testing.assert_array_equal(a.items, b.items)
        np.testing.assert_array_equal(a.scores, b.scores)
    # and a refresh publishes tensors the next step does not write
    trainer.refresh_dense()
    refreshed = [t.clone() for t in tree_leaves(cat.engine.params)]
    trainer.step(_batches(data, 2)[1])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(cat.engine.params), refreshed))


# ---------------------------------------------------------------------------
# the two packages' trainers on the same inputs
# ---------------------------------------------------------------------------
def test_trainers_match_the_reference(world):
    teng, data, tcfg, params, jeng, cfg = world
    jcat = JLiveCatalog(jeng, delta_capacity=cfg.n_items)
    jtrainer = JOnlineTrainer(jcat, cfg, jax.tree.map(jnp.asarray, params),
                              fold_every=2, compact_every=2)
    trainer, _ = _trainer(world, fold_every=2, compact_every=2)
    for b in _batches(data, 5):
        jl = jtrainer.step(b)
        tl = trainer.step(b)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for t in (jtrainer, trainer):
        t.fold()
    assert trainer.n_folds == jtrainer.n_folds == 3
    assert trainer.rows_folded == jtrainer.rows_folded == 3 * 90
    assert trainer.catalog.epoch == jcat.epoch == 1
    got = np.concatenate([t.numpy().ravel()
                          for t in tree_leaves(trainer.params)])
    want = np.concatenate([np.asarray(w).ravel() for w in
                           jax.tree_util.tree_leaves(jtrainer.params)])
    diff = np.abs(got - want)
    assert (diff > 1e-6).mean() <= 0.001 and diff.max() <= 1e-5


# ---------------------------------------------------------------------------
# concurrent train-while-serve (the deployment shape)
# ---------------------------------------------------------------------------
def test_train_while_serve_concurrent_smoke(world):
    """A training thread folds (and compacts) into the catalog while the
    concurrent front-end serves, the interpreter switching threads every
    0.1 ms: zero error tickets, every publication lands under the serve
    lock, and a final shadow checkpoint shows a zero gap."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        _train_while_serve(world)
    finally:
        sys.setswitchinterval(switch)


def _train_while_serve(world):
    engine, data, tcfg, params = world[:4]
    cat = LiveCatalog(engine, delta_capacity=engine.cfg.n_items)
    server = make_server(cat.engine, "concurrent", max_batch=8,
                         buckets=(8,), queue_depth=None)
    cat.attach(server)
    trainer = OnlineTrainer(cat, tcfg, params, fold_every=1,
                            compact_every=4)
    bs = _batches(data, 12)
    done = threading.Event()
    errors = []

    def train():
        try:
            for b in bs:
                trainer.step(b)
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)
        finally:
            done.set()

    th = threading.Thread(target=train, daemon=True)
    th.start()
    served = []
    queries = _queries(data, 16)

    def serve_round():
        tickets = [server.submit(q) for q in queries]
        served.extend(server.result(t, timeout=WAIT_S) for t in tickets)

    while not done.is_set():
        serve_round()
    th.join(timeout=WAIT_S)
    assert not th.is_alive() and not errors, errors
    serve_round()
    try:
        assert served and all(s.status == "ok" for s in served)
        assert server.stats()["n_errors"] == 0
        assert trainer.n_folds == 12
        assert cat.epoch >= 3  # compact_every=4 compacted under load
        rec = ShadowHarness(trainer, data, k=5,
                            probe_batch=64).checkpoint()
        assert rec.gap == 0.0 and rec.agree_frac == 1.0
    finally:
        server.close()
