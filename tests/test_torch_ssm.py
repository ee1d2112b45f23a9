"""The port's Mamba2 (SSD) block and its SSM and hybrid LM families
against `repro`, on the CPU.

Parameters come from the reference's `init_mamba2` / `init_params` and
reach the port through `convert.py`; tokens and activations are drawn
with numpy from fixed seeds. The configs are the reference's reduced
mamba2-1.3b (4 layers, 16 heads of 8, state 16, chunk 8) and zamba2-1.2b
(5 layers, the shared attention block every 2: two groups and a
remainder of one) in float32. `ssd_chunked` is also held against a
sequential recurrence written here in float64 (h_t = exp(dt_t A) h_{t-1}
+ dt_t x_t B_t^T, y_t = h_t C_t), the oracle the reference's docstring
names.

Tolerances, and why:
- `ssd_chunked`, the conv, `_segsum` and `mamba2_block` (outputs and the
  float32 conv and SSM states): 1e-5 of the largest magnitude against
  the reference, float32 einsums summed in another order; 1e-4 against
  the float64 recurrence, which sums in yet another order (a chunk's
  decay matrix against step-by-step products);
- the models' logits, hidden states and recurrent states: 1e-4, as the
  dense LM tests (`tests/test_torch_lm.py`): a stack of float32 layers;
- the shared attention block's KV caches: int8 values equal except one
  step apart at a .5 rounding boundary, in at most 0.5% of them, scales
  within 1e-5; bfloat16 values equal except one bfloat16 step apart,
  alike;
- prefill(S) + decode(1) against the train-mode forward of S + 1 tokens
  (the reference's own serving check, `tests/test_arch_smoke.py`) with a
  float32 cache: 1e-4;
- greedy tokens of `generate` equal.
Decode writes the KV caches in place and returns new recurrent states:
the caller's states keep their values and share no storage with the
new ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduce_config as jreduce
from repro.configs.registry import get_arch as jget_arch
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.serving import engine as jengine
from repro.serving.kv_cache import cache_bytes as jcache_bytes
from repro.serving.kv_cache import init_cache as jinit_cache
from repro_torch.configs.reduced import reduce_config
from repro_torch.configs.registry import get_arch
from repro_torch.convert import caches_from_numpy, lm_params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.models.attention import KVCacheView
from repro_torch.serving import engine as tengine
from repro_torch.serving.kv_cache import cache_bytes, init_cache
from repro_torch.utils import to_device, tree_leaves

MAMBA = "mamba2-1.3b"
ZAMBA = "zamba2-1.2b"
LAYER_TOL = 1e-5
ORACLE_TOL = 1e-4
MODEL_TOL = 1e-4
FLIP_FRAC = 0.005


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _configs(arch, **kw):
    return (jreduce(jget_arch(arch).model).with_(**kw),
            reduce_config(get_arch(arch).model).with_(**kw))


def _close(got, want, tol, what=""):
    """max |got - want| <= tol * max(1, max |want|)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------
def _ssd_inputs(B, L, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(
        np.float32) * 0.5
    A = -np.exp(np.linspace(0.0, 2.0, H)).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


def _recurrence(x, dt, A, Bm, Cm, s0):
    """The SSM step by step in float64: (y (B, L, H, P), final state)."""
    B, L, H, P = x.shape
    hpg = H // Bm.shape[2]
    Bh = np.repeat(Bm.astype(np.float64), hpg, axis=2)
    Ch = np.repeat(Cm.astype(np.float64), hpg, axis=2)
    h = np.zeros((B, H, P, Bm.shape[3])) if s0 is None else s0.astype(
        np.float64)
    y = np.zeros((B, L, H, P))
    for t in range(L):
        decay = np.exp(dt[:, t].astype(np.float64) * A)  # (B, H)
        xdt = x[:, t].astype(np.float64) * dt[:, t, :, None]
        h = h * decay[..., None, None] + xdt[..., None] * Bh[:, t, :, None]
        y[:, t] = (h * Ch[:, t, :, None]).sum(-1)
    return y, h


# (B, L, H, P, G, N, chunk, with init_state): whole chunks; L not a
# multiple of the chunk, two B/C groups and a carried-in state; L below
# one chunk
SSD_CASES = [(2, 16, 4, 8, 1, 16, 8, False), (2, 13, 4, 8, 2, 16, 8, True),
             (1, 5, 2, 4, 1, 8, 8, True)]


@pytest.mark.parametrize("B,L,H,P,G,N,chunk,init", SSD_CASES)
def test_ssd_chunked_matches_reference_and_recurrence(B, L, H, P, G, N,
                                                      chunk, init):
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(B, L, H, P, G, N, seed=L + G)
    s0 = s0 if init else None
    jy, jstate = jssm.ssd_chunked(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm),
        jnp.asarray(Cm), chunk, None if s0 is None else jnp.asarray(s0))
    ty, tstate = tssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm),
                                  chunk, None if s0 is None else _t(s0))
    assert ty.dtype == tstate.dtype == torch.float32
    _close(ty, jy, LAYER_TOL, "y")
    _close(tstate, jstate, LAYER_TOL, "state")
    wy, wstate = _recurrence(x, dt, A, Bm, Cm, s0)
    _close(ty, wy, ORACLE_TOL, "y vs recurrence")
    _close(tstate, wstate, ORACLE_TOL, "state vs recurrence")


def test_causal_conv_and_segsum_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    _close(tssm._causal_conv(_t(x), _t(w), _t(b)),
           jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
           LAYER_TOL)
    z = -np.abs(rng.standard_normal((3, 7))).astype(np.float32)
    got, want = tssm._segsum(_t(z)).numpy(), np.asarray(
        jssm._segsum(jnp.asarray(z)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=LAYER_TOL)


@pytest.mark.parametrize("S", [12, 2])  # S >= K - 1, and below it
def test_mamba2_block_prefill_and_decode_match_reference(S):
    jcfg, tcfg = _configs(MAMBA)
    p = _np_tree(jssm.init_mamba2(jax.random.key(0), jcfg))
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    tp = to_device(p, "cpu")
    jy, (jconv, jssm_s) = jssm.mamba2_block(_jnp_tree(p), jnp.asarray(x),
                                             jcfg)
    ty, (tconv, tssm_s) = tssm.mamba2_block(tp, _t(x), tcfg)
    _close(ty, jy, LAYER_TOL, "prefill y")
    assert tconv.dtype == tssm_s.dtype == torch.float32
    _close(tconv, jconv, LAYER_TOL, "conv state")
    _close(tssm_s, jssm_s, LAYER_TOL, "ssm state")

    x1 = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    jy1, (jconv1, jssm1) = jssm.mamba2_block(
        _jnp_tree(p), jnp.asarray(x1), jcfg, conv_state=jconv,
        ssm_state=jssm_s, decode=True)
    conv_in, ssm_in = _t(np.asarray(jconv)), _t(np.asarray(jssm_s))
    ty1, (tconv1, tssm1) = tssm.mamba2_block(
        tp, _t(x1), tcfg, conv_state=conv_in, ssm_state=ssm_in, decode=True)
    _close(ty1, jy1, LAYER_TOL, "decode y")
    _close(tconv1, jconv1, LAYER_TOL, "decode conv state")
    _close(tssm1, jssm1, LAYER_TOL, "decode ssm state")
    # the carries passed in are not written
    assert torch.equal(conv_in, _t(np.asarray(jconv)))
    assert torch.equal(ssm_in, _t(np.asarray(jssm_s)))


def test_init_mamba2_and_decode_state_have_the_reference_layout():
    jcfg, tcfg = _configs(MAMBA)
    want = jssm.init_mamba2(jax.random.key(0), jcfg)
    got = tssm.init_mamba2(torch.Generator().manual_seed(0), tcfg, "cpu",
                           lead=(3,))
    assert sorted(want) == sorted(got)
    for k in want:
        assert (3,) + tuple(want[k].shape) == tuple(got[k].shape), k
        assert str(want[k].dtype) == str(got[k].dtype).replace("torch.", "")
    for k in ("dt_bias", "A_log", "D", "conv_b", "norm_w"):  # constants
        np.testing.assert_allclose(got[k][1].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    assert tssm.conv_dim(tcfg) == jssm.conv_dim(jcfg)
    for a, b in zip(jssm.init_decode_state(jcfg, 2),
                    tssm.init_decode_state(tcfg, 2, device="cpu")):
        assert tuple(a.shape) == tuple(b.shape) and not bool(b.any())


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


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
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


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
@pytest.mark.parametrize("remat", ["none", "block"])
def test_forward_train_matches_reference(arch, remat):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    toks = _tokens(tcfg, 2, 21)  # not whole chunks of 8
    want = jtf.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                       mode="train", logits_mode="all", remat=remat)
    got = ttf.forward(tparams, tcfg, {"tokens": toks}, mode="train",
                      logits_mode="all", remat=remat)
    assert got.caches is None and float(got.aux_loss) == 0.0
    _close(got.logits, want.logits, MODEL_TOL, "logits")
    _close(got.hidden, want.hidden, MODEL_TOL, "hidden")


def _check_caches(tc, jc):
    """Cache trees leaf by leaf: recurrent states and scales within the
    model tolerance; int8 / bfloat16 KV values equal but for rounding
    flips one step apart in at most 0.5%."""
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(
        lambda _: 0, jc)).num_leaves == len(tree_leaves(tc))
    for t, j in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        if t.dtype in (torch.int8, torch.bfloat16):
            got, want = t.float().numpy(), j.astype(np.float32)
            step = 1.0 if t.dtype == torch.int8 else np.maximum(
                np.abs(want), 1e-30) * 2.0**-7
            diff = np.abs(got - want)
            off = diff > 0
            assert np.all(diff[off] <= np.broadcast_to(step, diff.shape)[off])
            assert off.mean() <= FLIP_FRAC
        else:
            _close(t, j, MODEL_TOL)


def _structure(cache):
    """The tree's shape: tuple / dict / KVCacheView / None / leaf."""
    if cache is None:
        return None
    if isinstance(cache, dict):
        return {k: _structure(v) for k, v in cache.items()}
    if isinstance(cache, tuple):
        kind = "kv" if hasattr(cache, "_fields") else "tuple"
        return (kind, tuple(_structure(v) for v in cache))
    return "leaf"


@pytest.mark.parametrize("arch,cache_dtype", [
    (MAMBA, "bfloat16"), (ZAMBA, "bfloat16"), (ZAMBA, "int8")])
def test_prefill_and_decode_match_reference(arch, cache_dtype):
    jcfg, tcfg, jparams, tparams = _setup(arch, seed=1)
    toks = _tokens(tcfg, 2, 14, seed=1)
    prefix, last = toks[:, :13], toks[:, 13:]
    jpre = jengine.prefill(jparams, jcfg, {"tokens": jnp.asarray(prefix)},
                           cache_len=18, cache_dtype=cache_dtype)
    tpre = tengine.prefill(tparams, tcfg, {"tokens": prefix}, cache_len=18,
                           cache_dtype=cache_dtype)
    _close(tpre.logits, jpre.logits, MODEL_TOL, "prefill logits")
    _check_caches(tpre.caches, jpre.caches)
    carried = caches_from_numpy(_np_tree(jpre.caches), "cpu")
    assert _structure(tpre.caches) == _structure(carried)
    if arch == ZAMBA:  # (attn, m_states, rem_state), rem_state present
        attn, m_states, (rem_attn, rem_m) = tpre.caches
        assert isinstance(attn, KVCacheView) and attn.k.shape[0] == 2
        assert m_states[0].shape[:2] == (2, 2) and rem_m[0].shape[0] == 1
        assert isinstance(rem_attn, KVCacheView) and rem_attn.k.dim() == 4

    before = [t.clone() for t in tree_leaves(carried)]
    jdec = jengine.decode_step(jparams, jcfg, {"tokens": jnp.asarray(last)},
                               jpre.caches, jnp.int32(13))
    tdec = tengine.decode_step(tparams, tcfg, {"tokens": last}, carried, 13)
    _close(tdec.logits, jdec.logits, MODEL_TOL, "decode logits")
    _check_caches(tdec.caches, jdec.caches)

    # KV caches written in place; recurrent states new, the caller's kept
    kv = [t for c in _kv_views(carried) for t in c if t is not None]
    new_kv = [t for c in _kv_views(tdec.caches) for t in c if t is not None]
    assert all(a is b for a, b in zip(kv, new_kv)) and len(kv) == len(new_kv)
    kv_ids = {id(t) for t in kv}
    new_ptrs = {t.untyped_storage().data_ptr()
                for t in tree_leaves(tdec.caches) if id(t) not in kv_ids}
    for old, t in zip(before, tree_leaves(carried)):
        if id(t) not in kv_ids:
            assert torch.equal(old, t)
            assert t.untyped_storage().data_ptr() not in new_ptrs


def _kv_views(cache):
    """The KVCacheViews of a cache tree, in order."""
    if isinstance(cache, KVCacheView):
        return [cache]
    if isinstance(cache, (tuple, list)):
        return [v for c in cache for v in _kv_views(c)]
    if isinstance(cache, dict):
        return [v for k in sorted(cache) for v in _kv_views(cache[k])]
    return []


def test_hybrid_decode_writes_every_invocations_cache():
    """Each of the shared block's invocations (both groups and the
    remainder) writes its own cache row at `cache_index`, and no other
    row."""
    _, tcfg, _, tparams = _setup(ZAMBA, seed=2)
    toks = _tokens(tcfg, 2, 6, seed=2)
    pre = tengine.prefill(tparams, tcfg, {"tokens": toks[:, :5]},
                          cache_len=8, cache_dtype="bfloat16")
    attn, _, (rem_attn, _) = pre.caches
    k_before = [attn.k.clone(), rem_attn.k.clone()]
    dec = tengine.decode_step(tparams, tcfg, {"tokens": toks[:, 5:]},
                              pre.caches, 5)
    attn2, _, (rem2, _) = dec.caches
    pairs = ((k_before[0], attn2.k), (k_before[1][None], rem2.k[None]))
    for old, new in pairs:
        for g in range(new.shape[0]):
            assert bool(new[g, :, :, 5].abs().sum() > 0), g
            assert bool((old[g, :, :, 5] == 0).all())
            keep = [i for i in range(new.shape[3]) if i != 5]
            assert torch.equal(new[g, :, :, keep], old[g, :, :, keep])
    # the three invocations see different inputs: their rows differ
    rows = [attn2.k[0, :, :, 5], attn2.k[1, :, :, 5], rem2.k[:, :, 5]]
    assert not torch.equal(rows[0], rows[1])
    assert not torch.equal(rows[1], rows[2])


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_prefill_then_decode_matches_full_forward(arch):
    """The reference's serving check on the port alone, float32 cache."""
    _, tcfg, _, tparams = _setup(arch, seed=3)
    toks = _tokens(tcfg, 2, 13, seed=3)
    full = ttf.forward(tparams, tcfg, {"tokens": toks}, mode="train",
                       logits_mode="last")
    pre = tengine.prefill(tparams, tcfg, {"tokens": toks[:, :12]},
                          cache_len=16, cache_dtype="float32")
    dec = tengine.decode_step(tparams, tcfg, {"tokens": toks[:, 12:]},
                              pre.caches, 12)
    _close(dec.logits[:, -1], full.logits[:, -1], MODEL_TOL)


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_generate_matches_reference_engine(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch, seed=4)
    prompt = _tokens(tcfg, 2, 9, seed=4)
    want = jengine.LMServingEngine(
        jparams, jcfg, batch=2, cache_len=16, cache_dtype="int8"
    ).generate({"tokens": jnp.asarray(prompt)}, n_steps=5)
    got = tengine.LMServingEngine(
        tparams, tcfg, batch=2, cache_len=16, cache_dtype="int8"
    ).generate({"tokens": prompt}, n_steps=5)
    assert got.tokens.shape == (2, 5) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_cache_layout_matches_reference(arch):
    jcfg, tcfg = _configs(arch)
    for dt in ("bfloat16", "int8"):
        want = jinit_cache(jcfg, 2, 16, dt)
        got = init_cache(tcfg, 2, 16, dt, device="cpu")
        assert _structure(got) == _structure(caches_from_numpy(
            _np_tree(want), "cpu"))
        for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert cache_bytes(got) == jcache_bytes(want)
    # without a remainder group the hybrid's rem_state is None
    if arch == ZAMBA:
        cfg4 = tcfg.with_(n_layers=4)
        assert init_cache(cfg4, 2, 16, device="cpu")[2] is None
        assert jinit_cache(jcfg.with_(n_layers=4), 2, 16)[2] is None


def test_serve_cli_runs_a_hybrid_arch_on_the_cpu(capsys):
    out = tserve.main(["--arch", ZAMBA, "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    assert out.tokens.shape == (2, 3)
    assert "on cpu" in capsys.readouterr().out
