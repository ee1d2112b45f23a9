"""The port's RecSys training against the JAX reference, on the CPU.

The same inputs (the reference's parameters from `jax.random.key(0)`,
carried across as numpy; batches from the shared synthetic generators)
go through `repro`'s and `repro_torch`'s losses, AdamW, train step and
fault-tolerant loop.

Tolerances, stated once:
  * losses within rtol 1e-5; gradients within 1e-5 of each leaf's largest
    magnitude (XLA's CPU dot and torch's sum in other orders; entries far
    below a leaf's scale differ relatively more);
  * AdamW over 5 updates of the same gradients: parameters within
    `PARAM_ATOL`; float32 moments within rtol 1e-5; bfloat16 and int8
    moments equal except in at most 0.5% of entries, each one step (one
    bfloat16 ulp, one int8 level) apart, where a value lands on a rounding
    boundary;
  * 5 train steps (gradients differ in their last bits): parameters within
    `PARAM_ATOL` in all but 0.1% of entries and within 1e-5 everywhere.
    AdamW divides by sqrt(v) + eps, so where a gradient entry is near eps
    (1e-8) its last-bit difference moves the step by up to ~1e-3 of lr
    (ROADMAP C.4).
Inside the port the loop's restart is held bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.distributed import training as jtr
from repro.models import recsys as jrs
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import dlrm_criteo, youtubednn_movielens
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.data import synthetic
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed import training as ttr
from repro_torch.models import recsys as trs
from repro_torch.optim import adamw
from repro_torch.utils import tree_leaves, tree_map

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
PARAM_ATOL = 1e-6
N_ITEMS = 90


@pytest.fixture(scope="module")
def world():
    data = jsyn.make_movielens(n_users=120, n_items=N_ITEMS, history_len=6)
    cfg = jrs.YoutubeDNNConfig(
        n_items=data.n_items,
        user_features={"user_id": data.n_users, "gender": 3, "age": 7,
                       "occupation": 21, "zip_bucket": 250},
        history_len=6)
    params = jrs.init_youtubednn(jax.random.key(0), cfg)
    return data, cfg, _tcfg(cfg), jax.tree.map(np.asarray, params)


def _tcfg(cfg):
    return trs.YoutubeDNNConfig(**{**cfg._asdict(),
                                   "user_features": dict(cfg.user_features)})


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jp(params):
    return jax.tree.map(jnp.asarray, params)


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _tp(params):
    return params_from_numpy(params, "cpu")


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_grads(tgrads, jgrads):
    got, want = tree_leaves(tgrads), _np_leaves(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max())


def _assert_value_and_grad(jloss_fn, tloss_fn, params, batch):
    jl, jg = jax.value_and_grad(lambda p: jloss_fn(p, _jb(batch)))(params)
    tl, tg = ttr.value_and_grad(tloss_fn)(_tp(params), _tb(batch))
    assert tl.shape == ()
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    _assert_grads(tg, jg)


# ---------------------------------------------------------------------------
# models: init, the three losses and their gradients
# ---------------------------------------------------------------------------
def test_init_youtubednn_shapes_and_scales(world):
    _, cfg, tcfg, jparams = world
    gen = torch.Generator().manual_seed(0)
    p = trs.init_youtubednn(gen, tcfg, device="cpu")
    got = tree_leaves(p)
    want = _np_leaves(jparams)
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert all(t.dtype == torch.float32 for t in got)
    assert all(not t.any() for layers in (p["filter_mlp"], p["rank_mlp"])
               for t in (layer["b"] for layer in layers))
    assert p["tables"]["user_id"].std().item() == pytest.approx(0.05,
                                                                rel=0.1)
    w0 = p["filter_mlp"][0]["w"]
    assert w0.std().item() == pytest.approx(w0.shape[0] ** -0.5, rel=0.1)
    # seeded: the same generator seed draws the same parameters
    again = trs.init_youtubednn(torch.Generator().manual_seed(0), tcfg,
                                device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, tree_leaves(again)))


def test_init_dlrm_shapes(world):
    cfg = jrs.DLRMConfig(cardinality=64)
    want = _np_leaves(jrs.init_dlrm(jax.random.key(0), cfg))
    got = tree_leaves(trs.init_dlrm(torch.Generator().manual_seed(0),
                                    trs.DLRMConfig(cardinality=64),
                                    device="cpu"))
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]


def test_configs_are_the_papers():
    assert youtubednn_movielens.model_config() == \
        trs.default_youtubednn_config()
    assert tuple(dlrm_criteo.model_config()) == tuple(jrs.DLRMConfig())


def test_filtering_loss_and_grads_match_reference(world):
    data, cfg, tcfg, jparams = world
    batch = next(synthetic.movielens_batches(data, 64, 1, seed=3))
    _assert_value_and_grad(lambda p, b: jrs.filtering_loss(p, cfg, b),
                           lambda p, b: trs.filtering_loss(p, tcfg, b),
                           jparams, batch)


def test_ranking_loss_and_grads_match_reference(world):
    data, cfg, tcfg, jparams = world
    batch = next(synthetic.movielens_rank_batches(data, 32, 8, 1, seed=4))
    _assert_value_and_grad(lambda p, b: jrs.ranking_loss(p, cfg, b),
                           lambda p, b: trs.ranking_loss(p, tcfg, b),
                           jparams, batch)
    logits_j = jrs.rank_tower(_jp(jparams), cfg, _jb(batch),
                              jnp.asarray(batch["cand_items"]))
    logits_t = trs.rank_tower(_tp(jparams), tcfg, _tb(batch),
                              torch.from_numpy(batch["cand_items"]))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-6)


def test_dlrm_loss_and_grads_match_reference():
    """Table I widths (26 tables, bottom 13-256-128-32, top 383-256-64-1)
    at 64 rows a table: the 351 pairwise dots in `triu_indices` order."""
    cfg = jrs.DLRMConfig(cardinality=64)
    tcfg = trs.DLRMConfig(cardinality=64)
    jparams = jax.tree.map(np.asarray, jrs.init_dlrm(jax.random.key(1), cfg))
    batch = next(synthetic.make_criteo_batches(32, 1, cardinality=64,
                                               seed=5))
    _assert_value_and_grad(lambda p, b: jrs.dlrm_loss(p, cfg, b),
                           lambda p, b: trs.dlrm_loss(p, tcfg, b),
                           jparams, batch)


def test_gathers_clamp_out_of_range_ids_as_jax_does(world):
    data, cfg, tcfg, jparams = world
    batch = next(synthetic.movielens_rank_batches(data, 8, 4, 1, seed=6))
    batch["cand_items"][0, :2] = (N_ITEMS + 5, -3)
    batch["genre"][1] = 40
    batch["user_id"][2] = 10_000
    want = jrs.rank_tower(_jp(jparams), cfg, _jb(batch),
                          jnp.asarray(batch["cand_items"]))
    got = trs.rank_tower(_tp(jparams), tcfg, _tb(batch),
                         torch.from_numpy(batch["cand_items"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# AdamW, schedule, clipping
# ---------------------------------------------------------------------------
def _opt_problem(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(16, 40)).astype(np.float32),
              "layers": [{"b": rng.normal(size=(24,)).astype(np.float32)}],
              "a": rng.normal(size=(3, 5, 8)).astype(np.float32)}
    grads = [jax.tree.map(lambda p: (rng.normal(size=p.shape) * 10.0 ** (
        rng.integers(-6, 1, p.shape))).astype(np.float32), params)
        for _ in range(5)]
    return params, grads


def _assert_steps_apart(got, want, step):
    """Equal except in at most 0.5% of entries, each one `step` apart."""
    off = got != want
    assert off.mean() <= 0.005, off.mean()
    step = np.broadcast_to(step, got.shape)
    assert (np.abs(got[off] - want[off]) <= step[off]).all()


def _assert_state(got, want, state_dtype):
    if state_dtype == "int8":
        v_got, v_want = got.values.numpy(), np.asarray(want.values)
        _assert_steps_apart(v_got.astype(np.int32), v_want.astype(np.int32),
                            1)
        np.testing.assert_allclose(got.scales.numpy(), np.asarray(
            want.scales), rtol=1e-5)
    elif state_dtype == "bfloat16":
        g = got.to(torch.float32).numpy()
        w = np.asarray(want).astype(np.float32)
        _assert_steps_apart(g, w, np.abs(w) * 2.0 ** -7)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-12)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_reference(state_dtype):
    params, grads = _opt_problem()
    jp, js = params, jadamw.init_adamw_state(params, state_dtype)
    tp, ts = _tp(params), adamw.init_adamw_state(_tp(params), state_dtype)
    for g in grads:
        jp, js = jadamw.adamw_update(g, js, jp, 1e-2, weight_decay=0.1,
                                     state_dtype=state_dtype)
        tp, ts = adamw.adamw_update(_tp(g), ts, tp, 1e-2, weight_decay=0.1,
                                    state_dtype=state_dtype)
    assert int(ts.count) == int(js.count) == 5
    for got, want in zip(tree_leaves(tp), _np_leaves(jp)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=PARAM_ATOL)
    for moments in ("mu", "nu"):
        got = tree_leaves(getattr(ts, moments))
        want = jax.tree_util.tree_leaves(
            getattr(js, moments),
            is_leaf=lambda x: isinstance(x, jadamw.QuantState))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_state(g, w, state_dtype)


def test_adamw_int8_state_keeps_the_params_rank():
    state = adamw.init_adamw_state({"w": torch.zeros(16, 256)}, "int8")
    assert state.mu["w"].values.dtype == torch.int8
    assert state.mu["w"].values.shape == (16, 256)
    assert state.mu["w"].scales.shape == (16, 1)


def test_adamw_update_is_out_of_place():
    params, grads = _opt_problem(1)
    tp = _tp(params)
    state = adamw.init_adamw_state(tp, "int8")
    kept = [t.clone() for t in tree_leaves(tp)]
    state_kept = [t.clone() for q in tree_leaves(state.mu)
                  for t in (q.values, q.scales)]
    new_p, new_s = adamw.adamw_update(_tp(grads[0]), state, tp, 1e-2,
                                      state_dtype="int8")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), kept))
    assert all(torch.equal(a, b) for a, b in zip(
        [t for q in tree_leaves(state.mu) for t in (q.values, q.scales)],
        state_kept))
    assert int(state.count) == 0 and int(new_s.count) == 1
    fresh = {id(t) for t in tree_leaves(new_p)}
    assert not fresh & {id(t) for t in tree_leaves(tp)}


@pytest.mark.parametrize("step", [0, 3, 9, 10, 55, 99, 150])
def test_cosine_schedule_matches_reference(step):
    want = jadamw.cosine_schedule(1e-3, warmup=10, total=100)(jnp.int32(step))
    got = adamw.cosine_schedule(1e-3, warmup=10, total=100)(
        torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(adamw.cosine_schedule(1e-3, 10, 100)(step)) == \
        pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    params, grads = _opt_problem(2)
    jc, jn = jadamw.clip_by_global_norm(grads[0], max_norm)
    tc, tn = adamw.clip_by_global_norm(_tp(grads[0]), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for got, want in zip(tree_leaves(tc), _np_leaves(jc)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # a tree in another key order sums its leaves in the same order
    swapped = dict(reversed(list(_tp(grads[0]).items())))
    assert torch.equal(adamw.global_norm(swapped), tn)


# ---------------------------------------------------------------------------
# the train step, from a carried-across reference state
# ---------------------------------------------------------------------------
def test_recsys_train_step_from_reference_state(world):
    """Two reference steps make a state with live moments; it carries
    across, and five more steps run on both sides from it."""
    data, cfg, tcfg, jparams = world
    batches = list(synthetic.movielens_batches(data, 64, 7, seed=1))
    jstep = jtr.make_recsys_train_step(cfg)
    js = jtr.init_recsys_train_state(_jp(jparams))
    for b in batches[:2]:
        js, _ = jstep(js, _jb(b))
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert int(ts.step) == 2 and int(ts.opt.count) == 2
    tstep = ttr.make_recsys_train_step(tcfg)
    for b in batches[2:]:
        js, jl = jstep(js, _jb(b))
        before = ts
        ts, tl = tstep(ts, b)
        assert ts is not before and tl.shape == ()
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert int(ts.step) == int(js.step) == 7
    got = np.concatenate([t.numpy().ravel() for t in tree_leaves(ts.params)])
    want = np.concatenate([w.ravel() for w in _np_leaves(js.params)])
    diff = np.abs(got - want)
    assert (diff > PARAM_ATOL).mean() <= 0.001, (diff > PARAM_ATOL).sum()
    assert diff.max() <= 1e-5


def test_train_state_carries_int8_and_bf16_moments():
    params, _ = _opt_problem(3)
    for dtype in ("int8", "bfloat16"):
        js = jtr.TrainState(params=params,
                            opt=jadamw.init_adamw_state(params, dtype),
                            step=jnp.int32(4))
        ts = train_state_from_numpy(js, "cpu")
        if dtype == "int8":
            assert isinstance(ts.opt.nu["w"], adamw.QuantState)
            assert ts.opt.nu["layers"][0]["b"].values.dtype == torch.int8
        else:
            assert ts.opt.mu["a"].dtype == torch.bfloat16
        assert int(ts.step) == 4


def test_entry_points_default_to_cuda(world):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a GPU")
    _, _, tcfg, jparams = world
    with pytest.raises(RuntimeError, match="CUDA"):
        trs.init_youtubednn(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.init_recsys_train_state(jparams)


# ---------------------------------------------------------------------------
# the fault-tolerant loop
# ---------------------------------------------------------------------------
def _loop_step(tcfg):
    step = ttr.make_recsys_train_step(tcfg)

    def train_step(state, batch):
        state, loss = step(state, batch)
        return state, {"loss": loss}

    return train_step


def _init_fn(jparams):
    return lambda: ttr.init_recsys_train_state(_tp(jparams), "cpu")


def _state_leaves(state):
    opt = state.opt
    return tree_leaves([state.params, opt.mu, opt.nu, opt.count, state.step])


def test_trainloop_checkpoint_restart_bitwise(world, tmp_path):
    """A hard kill at step 7 after the step-5 checkpoint; the restart from
    step 5 ends bit-equal to an uninterrupted run. The policy cannot flag
    a straggler, so the step-5 checkpoint is always written."""
    data, _, tcfg, jparams = world
    policy = ft.FaultPolicy(checkpoint_every=5,
                            straggler_factor=float("inf"))
    batches = list(synthetic.movielens_batches(data, 32, 10, seed=2))
    ref, end = ft.TrainLoop(_loop_step(tcfg), Checkpointer(tmp_path / "ref"),
                            policy).run(_init_fn(jparams)(), iter(batches),
                                        10)
    assert end == 10

    armed = {"on": True}

    def bomb(step):
        if step == 7 and armed["on"]:
            armed["on"] = False
            raise KeyboardInterrupt  # a hard kill, not a retryable fault

    with pytest.raises(KeyboardInterrupt):
        ft.TrainLoop(_loop_step(tcfg), Checkpointer(tmp_path / "crash"),
                     policy, fault_hook=bomb).run(
            _init_fn(jparams)(), iter(batches), 10)
    loop = ft.TrainLoop(_loop_step(tcfg), Checkpointer(tmp_path / "crash"),
                        policy)
    state, start = loop.resume_or_init(_init_fn(jparams))
    assert start == 5 and int(state.step) == 5
    final, end = loop.run(state, iter(batches[start:]), 10,
                          start_step=start)
    assert end == 10 and int(final.step) == 10
    for a, b in zip(_state_leaves(final), _state_leaves(ref)):
        assert torch.equal(a, b)


def test_trainloop_fresh_start_without_checkpoint(world, tmp_path):
    _, _, tcfg, jparams = world
    loop = ft.TrainLoop(_loop_step(tcfg), Checkpointer(tmp_path))
    state, start = loop.resume_or_init(_init_fn(jparams))
    assert start == 0 and int(state.step) == 0


def test_trainloop_retries_transient(world, tmp_path):
    data, _, tcfg, jparams = world
    attempts = {"n": 0}

    def flaky(step):
        if step == 3 and attempts["n"] < 2:
            attempts["n"] += 1
            raise ft.SimulatedTransientFailure("link flap")

    loop = ft.TrainLoop(_loop_step(tcfg), Checkpointer(tmp_path),
                        ft.FaultPolicy(max_retries_per_step=3),
                        fault_hook=flaky)
    _, end = loop.run(_init_fn(jparams)(),
                      synthetic.movielens_batches(data, 16, 6), 6)
    assert end == 6
    assert [r.retries for r in loop.records if r.step == 3] == [2]

    def dead(step):
        raise ft.SimulatedTransientFailure("down")

    loop = ft.TrainLoop(_loop_step(tcfg), Checkpointer(tmp_path / "dead"),
                        ft.FaultPolicy(max_retries_per_step=1),
                        fault_hook=dead)
    with pytest.raises(ft.SimulatedTransientFailure):
        loop.run(_init_fn(jparams)(), synthetic.movielens_batches(data, 16,
                                                                   2), 2)


def test_trainloop_straggler_skips_its_checkpoint(world, tmp_path,
                                                   monkeypatch):
    """A fake clock: step 4 takes 0.25 s against 0.01 s for the others, so
    it is flagged, and the checkpoint due after it is not written."""
    data, _, tcfg, jparams = world
    clock = {"t": 0.0, "calls": 0}

    def monotonic():
        # two reads a step: before and after train_step
        step, second = divmod(clock["calls"], 2)
        clock["calls"] += 1
        if second:
            clock["t"] += 0.25 if step == 4 else 0.01
        return clock["t"]

    monkeypatch.setattr(ft.time, "monotonic", monotonic)
    loop = ft.TrainLoop(_loop_step(tcfg), Checkpointer(tmp_path, keep=10),
                        ft.FaultPolicy(straggler_factor=5.0,
                                       checkpoint_every=5))
    loop.run(_init_fn(jparams)(), synthetic.movielens_batches(data, 16, 8),
             8)
    assert loop.straggler_events == [4]
    assert [r.straggler for r in loop.records] == [i == 4 for i in range(8)]
    assert loop.records[4].duration_s == pytest.approx(0.25)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000008"]


def test_tree_helpers_follow_jax_order():
    tree = {"b": [1, {"z": 2, "a": 3}], "a": None, "c": (4,)}
    assert tree_leaves(tree) == jax.tree_util.tree_leaves(tree)
    doubled = tree_map(lambda x, y: x + y, tree, tree)
    assert tree_leaves(doubled) == [2 * x for x in tree_leaves(tree)]
