"""The port's dense LM serving path (`repro_torch`) against `repro`.

Parameters come from the reference's `init_params` (`jax.random` draws
cannot be made in torch) and reach the port through
`convert.lm_params_from_numpy`; every other input is drawn with numpy from
a fixed seed and handed to both. The configs are the reference's reduced
qwen3-8b at 2 layers in float32 (qk-norm, GQA) and one reduced chatglm3-6b
case (partial rotary, qkv bias, here made nonzero).

Tolerances, and why:
- layers (rms_norm, apply_rope, mlp): 1e-5 — float32 ops in another order
  (and torch's own pow / rsqrt) move a value by a few ulps;
- attention, forward, prefill and decode logits: 1e-4 — a 2-layer stack
  of float32 matmuls and softmaxes summed in another order than XLA's;
- int8 KV caches: equal except where the port and JAX land on opposite
  sides of a .5 rounding boundary (their k and v differ by ulps); such
  values differ by exactly 1 and are counted and bounded (<= 0.5%);
- bfloat16 caches: equal except at a bf16 rounding boundary, where the
  two differ by one bf16 ulp (2**-8 relative), counted and bounded alike.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduce_config as jreduce
from repro.configs.registry import get_arch as jget_arch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serving import engine as jengine
from repro.serving.kv_cache import cache_bytes as jcache_bytes
from repro.serving.kv_cache import init_cache as jinit_cache
from repro_torch.configs import base as tbase
from repro_torch.configs.reduced import reduce_config
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.serving import engine as tengine
from repro_torch.serving.kv_cache import cache_bytes, init_cache
from repro_torch.utils import to_device

LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
FLIP_FRAC = 0.005  # bound on int8 / bf16 cache values off by one step


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _configs(arch, **kw):
    jcfg = jreduce(jget_arch(arch).model).with_(**kw)
    tcfg = reduce_config(get_arch(arch).model).with_(**kw)
    return jcfg, tcfg


def _setup(arch, seed=0, bias=False, **kw):
    """Reduced configs of `arch` and the same params on both sides."""
    jcfg, tcfg = _configs(arch, n_layers=2, **kw)
    tree = _np_tree(jtf.init_params(jcfg, jax.random.key(seed)))
    if bias:  # the reference inits biases to zero: exercise them
        rng = np.random.default_rng(seed + 1)
        for name in ("wq", "wk", "wv"):
            b = tree["layers"]["attn"][name]["b"]
            tree["layers"]["attn"][name]["b"] = (
                0.1 * rng.standard_normal(b.shape)).astype(b.dtype)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, lm_params_from_numpy(tree, "cpu")


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _assert_flips(got, want, step, what):
    """Equal except values off by exactly `step` (rounding boundaries)."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    diff = np.abs(got - want)
    off = diff > 0
    assert np.all(diff[off] <= np.broadcast_to(step, diff.shape)[off]), what
    assert off.mean() <= FLIP_FRAC, (what, int(off.sum()), off.size)
    return int(off.sum())


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_the_reference(arch):
    t, j = get_arch(arch), jget_arch(arch)
    assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
    assert dataclasses.asdict(t.parallel) == dataclasses.asdict(j.parallel)
    assert dict(t.skip_shapes) == dict(j.skip_shapes)
    tm, jm = reduce_config(t.model), jreduce(j.model)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    for prop in ("padded_vocab", "rep_kv_heads", "q_per_kv"):
        assert getattr(t.model, prop) == getattr(j.model, prop)
    from repro.configs.base import param_count_dense

    assert tbase.param_count_dense(t.model) == param_count_dense(j.model)


@pytest.mark.parametrize("arch", ["no-such-arch"])
def test_unported_arch_names_the_roadmap(arch):
    """Every arch of the reference is ported: an unknown id raises the
    reference's `KeyError`, naming the known ids."""
    with pytest.raises(KeyError, match="unknown arch.*qwen2-vl-72b"):
        get_arch(arch)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    _close(tlayers.rms_norm(_t(x), _t(w), 1e-6), want, LAYER_TOL)


@pytest.mark.parametrize("arch", ["qwen3-8b", "chatglm3-6b"])
def test_apply_rope_matches_reference(arch):
    jcfg, tcfg = _configs(arch)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, tcfg.head_dim)).astype(np.float32)
    pos = (np.arange(7)[None, :] + np.array([[0], [5]])).astype(np.int32)
    jang = jlayers.rope_angles(jcfg, jnp.asarray(pos))
    tang = tlayers.rope_angles(tcfg, _t(pos))
    _close(tang, jang, LAYER_TOL)
    want = jlayers.apply_rope(jnp.asarray(x), jang, jcfg.rope_fraction)
    got = tlayers.apply_rope(_t(x), tang, tcfg.rope_fraction)
    _close(got, want, LAYER_TOL)
    if tcfg.rope_fraction < 1:  # the unrotated half passes through
        rot = int(tcfg.head_dim * tcfg.rope_fraction)
        assert torch.equal(got[..., rot:], _t(x)[..., rot:])


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    jcfg, tcfg = _configs("qwen3-8b", act=act)
    p = _np_tree(jlayers.init_mlp(jax.random.key(3), jcfg))
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(
        np.float32)
    want = jlayers.mlp(jax.tree_util.tree_map(jnp.asarray, p),
                       jnp.asarray(x), jcfg)
    _close(tlayers.mlp(to_device(p, "cpu"), _t(x), tcfg), want, LAYER_TOL)


def test_init_params_has_the_reference_layout():
    for arch in ("qwen3-8b", "qwen2.5-3b"):  # lm_head and tied embeddings
        jcfg, tcfg = _configs(arch, n_layers=2)
        want = jtf.init_params(jcfg, jax.random.key(0))
        got = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        jl, jdef = jax.tree_util.tree_flatten_with_path(want)
        tl, _ = jax.tree_util.tree_flatten_with_path(got)
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (_, a), (_, b) in zip(jl, tl):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        # the reference's scales: embed 0.02, linear din**-0.5, norms ones
        assert abs(float(got["embed"].std()) - 0.02) < 0.002
        w = got["layers"]["mlp"]["wo"]["w"]
        assert abs(float(w.std()) * tcfg.d_ff**0.5 - 1) < 0.1
        assert bool((got["layers"]["norm1"] == 1).all())


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 5),
                                             (False, 0)])
def test_gqa_blocked_attention_matches_reference(causal, q_offset):
    rng = np.random.default_rng(4)
    q5 = rng.standard_normal((2, 2, 2, 9, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 14, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 14, 16)).astype(np.float32)
    want = jattn.gqa_blocked_attention(
        jnp.asarray(q5), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_offset, block_k=4)
    got = tattn.gqa_blocked_attention(_t(q5), _t(k), _t(v), causal=causal,
                                      q_offset=q_offset, block_k=4)
    _close(got, want, MODEL_TOL)


def test_quantize_kv_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    x[0, 0, 3] = 0.0  # an all-zero row takes the 1e-8 floor
    jq, js = jattn._quantize_kv(jnp.asarray(x))
    tq, ts = tattn._quantize_kv(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _close(tattn._dequantize_kv(tq, ts, torch.float32),
           jattn._dequantize_kv(jq, js, jnp.float32), 0)


@pytest.mark.parametrize("attn_impl", ["blocked", "flash"])
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_attention_prefill_matches_reference(monkeypatch, attn_impl,
                                             cache_dtype):
    monkeypatch.setenv("REPRO_PALLAS_FLASH_ATTENTION", "interpret")
    jcfg, tcfg, jparams, tparams = _setup("qwen3-8b")
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["attn"])
    tp = ttf._index(tparams["layers"], 0)["attn"]
    B, S = 2, 11
    x = np.random.default_rng(6).standard_normal((B, S, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jout, jc = jattn.attention(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                               make_cache=True, cache_len=16,
                               cache_dtype=cache_dtype, attn_impl=attn_impl)
    tout, tc = tattn.attention(tp, _t(x), tcfg, _t(pos), make_cache=True,
                               cache_len=16, cache_dtype=cache_dtype,
                               attn_impl=attn_impl)
    _close(tout, jout, MODEL_TOL)
    _check_caches(tc, jc, cache_dtype)


def _check_caches(tc, jc, cache_dtype):
    if cache_dtype == "int8":
        for f in ("k", "v"):
            _assert_flips(getattr(tc, f), getattr(jc, f), 1.0, f)
        for f in ("k_scale", "v_scale"):
            _close(getattr(tc, f), getattr(jc, f), LAYER_TOL)
    else:
        assert tc.k_scale is None and jc.k_scale is None
        for f in ("k", "v"):
            want = np.asarray(getattr(jc, f), np.float32)
            ulp = np.maximum(np.abs(want), 1e-30) * 2.0**-7
            _assert_flips(getattr(tc, f), want, ulp, f)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode, generate
# ---------------------------------------------------------------------------
def test_forward_train_logits_match_reference():
    jcfg, tcfg, jparams, tparams = _setup("qwen3-8b")
    toks = _tokens(tcfg, 2, 12)
    want = jtf.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                       mode="train", logits_mode="all")
    got = ttf.forward(tparams, tcfg, {"tokens": toks}, mode="train",
                      logits_mode="all")
    assert got.caches is None
    _close(got.logits, want.logits, MODEL_TOL)
    _close(got.hidden, want.hidden, MODEL_TOL)


@pytest.mark.parametrize("arch,bias", [("qwen3-8b", False),
                                       ("chatglm3-6b", True)])
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("attn_impl", ["blocked", "flash"])
def test_prefill_and_decode_match_reference(monkeypatch, arch, bias,
                                            cache_dtype, attn_impl):
    monkeypatch.setenv("REPRO_PALLAS_FLASH_ATTENTION", "interpret")
    jcfg, tcfg, jparams, tparams = _setup(arch, bias=bias)
    toks = _tokens(tcfg, 2, 13, seed=1)
    prefix, last = toks[:, :12], toks[:, 12:]
    jpre = jengine.prefill(jparams, jcfg, {"tokens": jnp.asarray(prefix)},
                           cache_len=16, cache_dtype=cache_dtype,
                           attn_impl=attn_impl)
    tpre = tengine.prefill(tparams, tcfg, {"tokens": prefix}, cache_len=16,
                           cache_dtype=cache_dtype, attn_impl=attn_impl)
    assert tpre.logits.shape == (2, 1, tcfg.padded_vocab)
    _close(tpre.logits, jpre.logits, MODEL_TOL)
    _check_caches(tpre.caches, jpre.caches, cache_dtype)

    # decode from the same cache on both sides (the reference's, carried
    # across), so the step itself is what is compared
    cache = tattn.KVCacheView(*(None if a is None else to_device(
        np.asarray(a), "cpu") for a in jpre.caches))
    jdec = jengine.decode_step(jparams, jcfg, {"tokens": jnp.asarray(last)},
                               jpre.caches, jnp.int32(12))
    tdec = tengine.decode_step(tparams, tcfg, {"tokens": last}, cache, 12)
    _close(tdec.logits, jdec.logits, MODEL_TOL)
    assert tdec.caches is cache  # written in place
    _check_caches(tdec.caches, jdec.caches, cache_dtype)


def test_decode_past_the_cache_raises():
    _, tcfg, _, tparams = _setup("qwen3-8b")
    cache = init_cache(tcfg, 2, 4, "int8", device="cpu")
    with pytest.raises(IndexError):
        tengine.decode_step(tparams, tcfg, {"tokens": np.zeros((2, 1),
                                                               np.int32)},
                            cache, 4)


def test_unembed_masks_the_padded_vocab():
    jcfg, tcfg, jparams, tparams = _setup("qwen3-8b", vocab_size=100)
    assert tcfg.padded_vocab == 128
    h = np.random.default_rng(7).standard_normal((2, 3, 64)).astype(
        np.float32)
    want = jtf.unembed(jparams, jcfg, jnp.asarray(h))
    got = ttf.unembed(tparams, tcfg, _t(h))
    _close(got, want, MODEL_TOL)
    assert bool((got[..., 100:] == -1e30).all())


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_generate_matches_reference_engine(cache_dtype):
    jcfg, tcfg, jparams, tparams = _setup("qwen3-8b")
    prompt = _tokens(tcfg, 2, 8, seed=2)
    want = jengine.LMServingEngine(
        jparams, jcfg, batch=2, cache_len=48, cache_dtype=cache_dtype
    ).generate({"tokens": jnp.asarray(prompt)}, n_steps=6)
    got = tengine.LMServingEngine(
        tparams, tcfg, batch=2, cache_len=48, cache_dtype=cache_dtype
    ).generate({"tokens": prompt}, n_steps=6)
    assert got.tokens.shape == (2, 6) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_cache_layout_matches_reference():
    jcfg, tcfg = _configs("qwen3-8b", n_layers=2)
    for dt in ("bfloat16", "int8"):
        want = jinit_cache(jcfg, 2, 16, dt)
        got = init_cache(tcfg, 2, 16, dt, device="cpu")
        for a, b in zip(want, got):
            assert (a is None) == (b is None)
            if a is not None:
                assert tuple(a.shape) == tuple(b.shape)
                assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert cache_bytes(got) == jcache_bytes(want)


def test_serve_cli_runs_on_the_cpu(capsys):
    out = tserve.main(["--arch", "qwen3-8b", "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    assert out.tokens.shape == (2, 3)
    assert "on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# carrying weights across
# ---------------------------------------------------------------------------
def test_lm_params_from_numpy_keeps_bf16_bits():
    jcfg, _ = _configs("qwen3-8b", n_layers=2, dtype="bfloat16")
    tree = _np_tree(jtf.init_params(jcfg, jax.random.key(0)))
    got = lm_params_from_numpy(tree, "cpu")
    leaves = jax.tree_util.tree_leaves(tree)
    tleaves = jax.tree_util.tree_leaves(got)
    assert len(leaves) == len(tleaves)
    for a, t in zip(leaves, tleaves):
        assert a.dtype.name == "bfloat16" and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))


def test_to_device_carries_a_bf16_array():
    a = np.asarray(jnp.asarray([[1.5, -2.0e-3, 3.0e38], [0.0, -0.0, 7.0]],
                               jnp.bfloat16))
    t = to_device(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
