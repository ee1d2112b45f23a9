"""The port's Mixture-of-Experts layer and its two LM families against
`repro`, on the CPU.

Parameters come from the reference's `init_moe` / `init_params` and reach
the port through `convert.py`; tokens and activations are drawn with
numpy from fixed seeds. The configs are the reference's reduced
phi3.5-moe (4 experts, top-2, gelu experts) and llama4-maverick (4
experts, top-1, a shared expert, dense and MoE layers alternating) in
float32, 4 layers. The reference's routing tensors are read where
`models/moe.py` passes them through its sharding hook (`constrain`):
dispatch, the experts' inputs and their outputs, inside the layer scan
through `jax.debug.callback`.

Tolerances, and why:
- routing bit for bit at the layer's own inputs: top-k indices (ties to
  the lower expert), the bfloat16 dispatch one-hots (expert, slot and
  capacity), the experts' bfloat16 inputs, and the float32 combine
  weights equal to the dispatch times the reference's renormalized
  top-k weights within 1e-6 (the float32 softmax summed in another
  order);
- the aux loss within 1e-6;
- the layer's output within 1e-2 of its largest magnitude
  (`MOE_OUT_TOL`): the experts run in bfloat16 even in a float32 model,
  as in the reference, and a product summed in another order can round
  one bfloat16 step (2**-8 relative) apart (2.1e-3 measured at 2,048
  tokens; below 1e-6 at a few dozen);
- the models' logits and hidden states within 1e-2 of their largest
  magnitude for the same reason (a flip in one layer reaches every later
  one), the aux loss within 1e-5 relative;
- routing inside the models: a token whose kept experts differ between
  the two at some layer (its inputs there differ by bfloat16 steps) is a
  flip; flips are counted and bounded by 1% of the routed tokens
  (`FLIP_FRAC`); none occurred at these seeds;
- KV caches of the layers no expert output has reached yet: int8 values
  equal except one step apart at a .5 rounding boundary, at most 0.5% of
  them (`tests/test_torch_lm.py`), scales and bfloat16 values within
  1e-5 of the largest; later layers' int8 values at most one step apart
  and the rest within the model tolerance;
- greedy tokens of `generate` equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
from repro.configs.reduced import reduce_config as jreduce
from repro.configs.registry import get_arch as jget_arch
from repro.models import transformer as jtf
from repro.serving import engine as jengine
from repro.serving.kv_cache import cache_bytes as jcache_bytes
from repro.serving.kv_cache import init_cache as jinit_cache
from repro_torch.configs.reduced import reduce_config
from repro_torch.configs.registry import get_arch
from repro_torch.convert import caches_from_numpy, lm_params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serving import engine as tengine
from repro_torch.serving.kv_cache import cache_bytes, init_cache
from repro_torch.utils import to_device, tree_leaves

PHI = "phi3.5-moe-42b-a6.6b"
LLAMA4 = "llama4-maverick-400b-a17b"
MOE_OUT_TOL = 1e-2
MODEL_TOL = 1e-2
AUX_TOL = 1e-6
COMBINE_TOL = 1e-6
FLIP_FRAC = 0.01
CACHE_FLIP_FRAC = 0.005


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _configs(arch, **kw):
    return (jreduce(jget_arch(arch).model).with_(**kw),
            reduce_config(get_arch(arch).model).with_(**kw))


def _close_to_max(got, want, frac, what=""):
    """max |got - want| <= frac * max |want|."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (what, err,
                                              np.abs(want).max())


@pytest.fixture
def ref_routing(monkeypatch):
    """The reference's dispatch, expert inputs and expert outputs of every
    `moe_layer` call, in call order (also from inside a scan)."""
    seen = []

    def hook(x, spec):
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), x,
                           ordered=True)
        return x

    monkeypatch.setattr(jmoe, "constrain", hook)
    return seen


@pytest.fixture
def port_routing(monkeypatch):
    """The port's `Routing` of every `moe_layer` call, in call order."""
    seen = []
    route = tmoe.route

    def spy(*args):
        seen.append(route(*args))
        return seen[-1]

    monkeypatch.setattr(tmoe, "route", spy)
    return seen


def _ref_topk(router, xg, cfg):
    gates = jax.nn.softmax(jnp.asarray(xg, jnp.float32) @ router, axis=-1)
    topw, topi = jax.lax.top_k(gates, cfg.moe_top_k)
    return np.asarray(topi), np.asarray(
        topw / jnp.maximum(topw.sum(-1, keepdims=True), 1e-9))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
# (arch, B, S, capacity_factor or None for the reduced config's 2.0):
# one group; 2,048 tokens, two groups; drops at capacity factor 0.5;
# llama4's top-1 with a shared expert, with and without drops
LAYER_CASES = [(PHI, 2, 16, None), (PHI, 2, 1024, None), (PHI, 2, 64, 0.5),
               (LLAMA4, 2, 16, None), (LLAMA4, 4, 32, 0.5)]


@pytest.mark.parametrize("arch,B,S,cf", LAYER_CASES)
def test_moe_layer_matches_reference(ref_routing, arch, B, S, cf):
    kw = {} if cf is None else {"capacity_factor": cf}
    jcfg, tcfg = _configs(arch, **kw)
    p = _np_tree(jmoe.init_moe(jax.random.key(1), jcfg))
    x = np.random.default_rng(B * S).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_layer(_jnp_tree(p), jnp.asarray(x), jcfg)
    jdispatch, jexpert_in, _ = ref_routing

    tp = to_device(p, "cpu")
    ty, taux = tmoe.moe_layer(tp, torch.from_numpy(x), tcfg)
    gsz, cap = tmoe.capacity(tcfg, B * S)
    xg = x.reshape(-1, gsz, tcfg.d_model)
    r = tmoe.route(tp["router"], torch.from_numpy(xg), tcfg, cap)

    topi, topw = _ref_topk(jnp.asarray(p["router"]), xg, jcfg)
    np.testing.assert_array_equal(r.topi.numpy(), topi)
    assert r.dispatch.dtype == torch.bfloat16
    np.testing.assert_array_equal(r.dispatch.float().numpy(),
                                  np.asarray(jdispatch, np.float32))
    # combine = the kept one-hots times each choice's weight
    want_combine = np.zeros(r.combine.shape, np.float32)
    d = np.asarray(jdispatch, np.float32)
    for j in range(tcfg.moe_top_k):
        onehot = (np.arange(tcfg.n_experts) == topi[..., j, None])
        want_combine += d * onehot[..., None] * topw[..., j, None, None]
    np.testing.assert_allclose(r.combine.numpy(), want_combine, rtol=0,
                               atol=COMBINE_TOL)
    expert_in = torch.einsum("gsec,gsd->egcd", r.dispatch,
                             torch.from_numpy(xg).to(torch.bfloat16))
    np.testing.assert_array_equal(expert_in.float().numpy(),
                                  np.asarray(jexpert_in, np.float32))
    kept = int(d.sum())
    if cf is not None:  # the case is meant to drop tokens
        assert kept < B * S * tcfg.moe_top_k
    _close_to_max(ty, jy, MOE_OUT_TOL, "y")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0,
                               atol=AUX_TOL)


def test_top_k_ties_go_to_the_lower_expert(ref_routing):
    """A zero router ties every gate: the reference's top-k takes the
    lowest expert ids, and the slot claim fills the first tokens of each
    group (slot 0 of every token before slot 1) up to capacity."""
    jcfg, tcfg = _configs(PHI, capacity_factor=0.5)
    p = _np_tree(jmoe.init_moe(jax.random.key(2), jcfg))
    p["router"] = np.zeros_like(p["router"])
    x = np.random.default_rng(3).standard_normal(
        (1, 40, tcfg.d_model)).astype(np.float32)
    jmoe.moe_layer(_jnp_tree(p), jnp.asarray(x), jcfg)
    tp = to_device(p, "cpu")
    gsz, cap = tmoe.capacity(tcfg, 40)
    r = tmoe.route(tp["router"], torch.from_numpy(x), tcfg, cap)
    assert bool((r.topi == torch.arange(tcfg.moe_top_k)).all())
    np.testing.assert_array_equal(r.dispatch.float().numpy(),
                                  np.asarray(ref_routing[0], np.float32))
    kept = r.dispatch.float().sum((0, 3))  # (S, E)
    assert bool((kept[:cap, :2] == 1).all()) and float(kept[cap:].sum()) == 0


@pytest.mark.parametrize("arch,tokens,want", [
    # full size: prefill groups of 1,024 tokens, decode at batch 4
    (PHI, 8192, (1024, 160)), (PHI, 4, (4, 1)),
    (LLAMA4, 8192, (1024, 10)), (LLAMA4, 4, (4, 1))])
def test_capacity_at_full_size(arch, tokens, want):
    cfg = get_arch(arch).model
    assert tmoe.capacity(cfg, tokens) == want
    jcfg = jget_arch(arch).model
    gsz = min(jmoe.MOE_GROUP_SIZE, tokens)
    assert want[1] == max(1, int(gsz * jcfg.moe_top_k
                                 * jcfg.capacity_factor / jcfg.n_experts))


def test_init_moe_has_the_reference_layout():
    for arch in (PHI, LLAMA4):
        jcfg, tcfg = _configs(arch)
        want = jmoe.init_moe(jax.random.key(0), jcfg)
        got = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg, "cpu",
                            lead=(3,))
        jl = jax.tree_util.tree_flatten_with_path(want)[0]
        tl = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (_, a), (_, b) in zip(jl, tl):
            assert (3,) + tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert got["router"].dtype == torch.float32
        d, f = tcfg.d_model, tcfg.d_ff
        assert abs(float(got["wi"].std()) * d**0.5 - 1) < 0.1
        assert abs(float(got["wo"].std()) * f**0.5 - 1) < 0.1


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
def _setup(arch, seed=0, **kw):
    jcfg, tcfg = _configs(arch, **kw)
    tree = _np_tree(jtf.init_params(jcfg, jax.random.key(seed)))
    return jcfg, tcfg, _jnp_tree(tree), lm_params_from_numpy(tree, "cpu")


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _routing_flips(port, ref):
    """Tokens whose kept experts differ, over every layer call, and the
    tokens routed. `ref` holds three captures a call."""
    jd = ref[0::3]
    assert len(port) == len(jd)
    flips = routed = 0
    for r, d in zip(port, jd):
        a = r.dispatch.float().sum(-1).numpy()  # (G, S, E) kept
        b = np.asarray(d, np.float32).sum(-1)
        flips += int((a != b).any(-1).sum())
        routed += a.shape[0] * a.shape[1]
    return flips, routed


@pytest.mark.parametrize("arch", [PHI, LLAMA4])
def test_init_params_has_the_reference_layout(arch):
    jcfg, tcfg = _configs(arch)
    want = jtf.init_params(jcfg, jax.random.key(0))
    got = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", [PHI, LLAMA4])
def test_forward_train_matches_reference(ref_routing, port_routing, arch):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    toks = _tokens(tcfg, 2, 24)
    want = jtf.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                       mode="train", logits_mode="all")
    jax.effects_barrier()
    got = ttf.forward(tparams, tcfg, {"tokens": toks}, mode="train",
                      logits_mode="all")
    assert got.caches is None
    _close_to_max(got.logits, want.logits, MODEL_TOL, "logits")
    _close_to_max(got.hidden, want.hidden, MODEL_TOL, "hidden")
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               rtol=1e-5)
    assert float(got.aux_loss) > 0
    flips, routed = _routing_flips(port_routing, ref_routing)
    assert len(port_routing) == tcfg.n_layers // tcfg.moe_layer_step
    assert flips <= FLIP_FRAC * routed, (flips, routed)


def _check_caches(tc, jc, cache_dtype):
    """KV cache trees leaf by leaf. Each leaf's first layer (phi's layer
    0; llama4's layers 0 and 1) sees no expert output yet: int8 values
    one step apart in at most 0.5%, scales within 1e-5, bfloat16 values
    within 1e-5 of the largest. Later layers see the experts' bfloat16
    steps: int8 values at most one step apart, scales and bfloat16 values
    within the model tolerance."""
    tl, jl = tree_leaves(tc), jax.tree_util.tree_leaves(jc)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        if t.dtype == torch.int8:
            diff = np.abs(t.numpy().astype(np.int32) - j.astype(np.int32))
            assert diff.max() <= 1
            assert (diff[0] > 0).mean() <= CACHE_FLIP_FRAC
        else:
            _close_to_max(t[0], j[0], 1e-5)
            _close_to_max(t, j, MODEL_TOL)


@pytest.mark.parametrize("arch", [PHI, LLAMA4])
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_prefill_and_decode_match_reference(ref_routing, port_routing, arch,
                                            cache_dtype):
    jcfg, tcfg, jparams, tparams = _setup(arch, seed=1)
    toks = _tokens(tcfg, 2, 17, seed=1)
    prefix, last = toks[:, :16], toks[:, 16:]
    jpre = jengine.prefill(jparams, jcfg, {"tokens": jnp.asarray(prefix)},
                           cache_len=20, cache_dtype=cache_dtype)
    tpre = tengine.prefill(tparams, tcfg, {"tokens": prefix}, cache_len=20,
                           cache_dtype=cache_dtype)
    assert tpre.logits.shape == (2, 1, tcfg.padded_vocab)
    _close_to_max(tpre.logits, jpre.logits, MODEL_TOL, "prefill logits")
    _check_caches(tpre.caches, jpre.caches, cache_dtype)
    if tcfg.moe_layer_step == 2:
        assert set(tpre.caches) == {"dense", "moe"}

    # decode from the reference's cache, carried across
    cache = caches_from_numpy(_np_tree(jpre.caches), "cpu")
    jdec = jengine.decode_step(jparams, jcfg, {"tokens": jnp.asarray(last)},
                               jpre.caches, jnp.int32(16))
    jax.effects_barrier()
    tdec = tengine.decode_step(tparams, tcfg, {"tokens": last}, cache, 16)
    _close_to_max(tdec.logits, jdec.logits, MODEL_TOL, "decode logits")
    assert tree_leaves(tdec.caches)[0] is tree_leaves(cache)[0]  # in place
    _check_caches(tdec.caches, jdec.caches, cache_dtype)
    flips, routed = _routing_flips(port_routing, ref_routing)
    assert flips <= FLIP_FRAC * routed, (flips, routed)


@pytest.mark.parametrize("arch", [PHI, LLAMA4])
def test_generate_matches_reference_engine(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch, seed=2)
    prompt = _tokens(tcfg, 2, 8, seed=2)
    want = jengine.LMServingEngine(
        jparams, jcfg, batch=2, cache_len=16, cache_dtype="int8"
    ).generate({"tokens": jnp.asarray(prompt)}, n_steps=5)
    got = tengine.LMServingEngine(
        tparams, tcfg, batch=2, cache_len=16, cache_dtype="int8"
    ).generate({"tokens": prompt}, n_steps=5)
    assert got.tokens.shape == (2, 5) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("arch", [PHI, LLAMA4])
def test_cache_layout_matches_reference(arch):
    jcfg, tcfg = _configs(arch)
    for dt in ("bfloat16", "int8"):
        want = jinit_cache(jcfg, 2, 16, dt)
        got = init_cache(tcfg, 2, 16, dt, device="cpu")
        assert jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda _: 0, want)).num_leaves == len(
            tree_leaves(got))
        for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert cache_bytes(got) == jcache_bytes(want)


def test_serve_cli_runs_an_moe_arch_on_the_cpu(capsys):
    out = tserve.main(["--arch", LLAMA4, "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    assert out.tokens.shape == (2, 3)
    assert "on cpu" in capsys.readouterr().out
