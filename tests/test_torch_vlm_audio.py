"""The port's VLM (qwen2-vl-72b), audio (musicgen-large) and largest dense
(llama3-405b) configs against `repro`, on the CPU.

Parameters come from the reference's `init_params` and reach the port
through `convert.lm_params_from_numpy` (the VLM's zero-initialized qkv
biases made nonzero); tokens, patch embeddings, vision slots and M-RoPE
positions are drawn with numpy from fixed seeds and handed to both. The
configs are the reference's reduced ones in float32 at 2 layers: the VLM
with M-RoPE sections (2, 3, 3) and 4 vision tokens, the audio model with
2 codebooks of 64 ids (4 where a test says so), llama3-405b as a reduced
GQA dense model. The VLM's positions differ between their three
components: text slots hold their own index in all three, and the slots
of a 2 x 2 image block at t0 hold (t0, t0 + row, t0 + column), as the
Qwen2-VL frontend lays them out; vision slots never repeat within a row
(the reference's scatter gives a repeated slot no defined order).

Tolerances, and why (those of `tests/test_torch_lm.py`):
- RoPE frequencies and M-RoPE angles bit for bit, at the reduced and at
  the full sections: the same float32 products, selected;
  `apply_rope` within 1e-5 (torch's own cos / sin);
- the embeddings bit for bit: a gather, the scatter, and for the audio
  model a sum of K float32 rows (2 rows: one rounding, in either order;
  at 4 rows within 1e-6 of the largest, as the two may add in other
  orders); their gradients within 1e-6 (duplicate ids summed in another
  order);
- forward, prefill and decode logits: 1e-4 (float32 stacks summed in
  another order than XLA's);
- int8 and bfloat16 KV caches: equal but for values one rounding step
  apart at a boundary, at most 0.5% of them;
- greedy tokens of `generate` equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JParallelConfig
from repro.configs.reduced import reduce_config as jreduce
from repro.configs.registry import all_arches as jall_arches
from repro.configs.registry import get_arch as jget_arch
from repro.distributed import training as jtr
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serving import engine as jengine
from repro.serving.kv_cache import cache_bytes as jcache_bytes
from repro.serving.kv_cache import init_cache as jinit_cache
from repro_torch.configs.base import ParallelConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.configs.registry import ARCH_IDS, all_arches, get_arch
from repro_torch.convert import caches_from_numpy, lm_params_from_numpy
from repro_torch.data.lm_data import synthetic_token_stream
from repro_torch.distributed import training as ttr
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.serving import engine as tengine
from repro_torch.serving.kv_cache import cache_bytes, init_cache
from repro_torch.utils import tree_leaves

VLM = "qwen2-vl-72b"
AUDIO = "musicgen-large"
LLAMA405 = "llama3-405b"
NEW_ARCHES = (VLM, AUDIO, LLAMA405)
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
EMBED_TOL = 1e-6
FLIP_FRAC = 0.005


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _configs(arch, **kw):
    return (jreduce(jget_arch(arch).model).with_(**kw),
            reduce_config(get_arch(arch).model).with_(**kw))


def _setup(arch, seed=0, **kw):
    """Reduced configs of `arch` at 2 layers and the same params on both
    sides; qkv biases (the VLM's) made nonzero."""
    jcfg, tcfg = _configs(arch, n_layers=2, **kw)
    tree = _np_tree(jtf.init_params(jcfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed + 1)
    for name in ("wq", "wk", "wv"):
        b = tree["layers"]["attn"][name].get("b")
        if b is not None:
            tree["layers"]["attn"][name]["b"] = (
                0.1 * rng.standard_normal(b.shape)).astype(b.dtype)
    return jcfg, tcfg, _jnp_tree(tree), lm_params_from_numpy(tree, "cpu")


def _mrope_positions(B, S, t0, h, w):
    """(3, B, S) int32: text slots their own index in all components, the
    h x w image block at slots t0.. (row-major) (t0, t0 + r, t0 + c)."""
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    r, c = np.divmod(np.arange(h * w), w)
    block = slice(t0, t0 + h * w)
    pos[0, :, block] = t0
    pos[1, :, block] = t0 + r
    pos[2, :, block] = t0 + c
    return pos


def _batch(cfg, B, S, seed=0):
    """numpy prompt: the audio model's (B, K, S) grid; the VLM's tokens,
    patch embeddings at a 2 x 2 block of slots (at a row-dependent start)
    and its M-RoPE positions."""
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks, S) if cfg.family == "audio" else (B, S)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.family == "vlm":
        nv = cfg.vision_tokens
        assert nv == 4
        out["vision_embeds"] = rng.standard_normal(
            (B, nv, cfg.d_model)).astype(np.float32)
        t0 = 3
        out["vision_pos"] = np.broadcast_to(
            np.arange(t0, t0 + nv, dtype=np.int32), (B, nv)).copy()
        out["positions"] = _mrope_positions(B, S, t0, 2, 2)
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _prefix(batch, n):
    """The first `n` slots of a prompt (positions and tokens cut; the
    vision inputs kept: their slots lie before `n`)."""
    out = dict(batch)
    out["tokens"] = batch["tokens"][..., :n]
    if "positions" in batch:
        out["positions"] = batch["positions"][..., :n]
    return out


def _assert_flips(got, want, step, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    diff = np.abs(got - want)
    off = diff > 0
    assert np.all(diff[off] <= np.broadcast_to(step, diff.shape)[off]), what
    assert off.mean() <= FLIP_FRAC, (what, int(off.sum()), off.size)


def _check_caches(tc, jc, cache_dtype):
    if cache_dtype == "int8":
        for f in ("k", "v"):
            _assert_flips(getattr(tc, f), getattr(jc, f), 1.0, f)
        for f in ("k_scale", "v_scale"):
            _close(getattr(tc, f), getattr(jc, f), LAYER_TOL, f)
    else:
        assert tc.k_scale is None and jc.k_scale is None
        for f in ("k", "v"):
            want = np.asarray(getattr(jc, f), np.float32)
            ulp = np.maximum(np.abs(want), 1e-30) * 2.0**-7
            _assert_flips(getattr(tc, f), want, ulp, f)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_all_arches_equal_the_reference():
    got, want = all_arches(), jall_arches()
    assert list(got) == list(want) == list(ARCH_IDS)
    for arch in ARCH_IDS:
        assert dataclasses.asdict(got[arch].model) == \
            dataclasses.asdict(want[arch].model)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)])
def test_mrope_angles_bit_equal_and_rope_matches(sections):
    hd = 2 * sum(sections)
    jcfg, tcfg = _configs(VLM, head_dim=hd, mrope_sections=sections)
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 5000, (3, 2, 9)).astype(np.int32)  # all differ
    jang = jlayers.rope_angles(jcfg, jnp.asarray(pos))
    tang = tlayers.rope_angles(tcfg, _t(pos))
    assert tang.shape == (2, 9, hd // 2)
    np.testing.assert_array_equal(tang.numpy(), np.asarray(jang))
    # each frequency band reads its own component
    lo = 0
    for i, s in enumerate(sections):
        plain = tlayers.rope_angles(tcfg.with_(rope_style="standard"),
                                    _t(pos[i]))
        assert torch.equal(tang[..., lo:lo + s], plain[..., lo:lo + s])
        lo += s
    x = rng.standard_normal((2, 9, 4, hd)).astype(np.float32)
    want = jlayers.apply_rope(jnp.asarray(x), jang, jcfg.rope_fraction)
    _close(tlayers.apply_rope(_t(x), tang, tcfg.rope_fraction), want,
           LAYER_TOL)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if get_arch(a).model.head_dim])
def test_rope_inv_freq_bit_equal_at_full_size(arch):
    """The full configs' frequencies (any rope_theta, rotary width)."""
    jcfg, tcfg = jget_arch(arch).model, get_arch(arch).model
    np.testing.assert_array_equal(tlayers.rope_inv_freq(tcfg, "cpu").numpy(),
                                  np.asarray(jlayers.rope_inv_freq(jcfg)))


def test_mrope_with_equal_components_is_standard_rope():
    _, tcfg = _configs(VLM)
    pos = np.arange(11, dtype=np.int32)[None].repeat(2, 0) + 7
    got = tlayers.rope_angles(tcfg, _t(np.stack([pos] * 3)))
    want = tlayers.rope_angles(tcfg.with_(rope_style="standard"), _t(pos))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="3, B, S"):
        tlayers.rope_angles(tcfg, _t(pos))


def test_default_positions_broadcast_for_mrope():
    jcfg, tcfg = _configs(VLM)
    b = {"tokens": np.zeros((2, 5), np.int32)}
    want = jtf.default_positions(jcfg, _jb(b), 2, 5, offset=3)
    got = ttf.default_positions(tcfg, {"tokens": _t(b["tokens"])}, 2, 5,
                                offset=3)
    assert got.shape == (3, 2, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# embeddings in and out
# ---------------------------------------------------------------------------
def test_vision_scatter_matches_reference_with_its_gradient():
    jcfg, tcfg, jparams, tparams = _setup(VLM)
    rng = np.random.default_rng(3)
    B, S, nv = 3, 10, tcfg.vision_tokens
    batch = {"tokens": rng.integers(0, 8, (B, S)).astype(np.int32),
             "vision_embeds": rng.standard_normal(
                 (B, nv, tcfg.d_model)).astype(np.float32),
             "vision_pos": np.stack([rng.choice(S, nv, replace=False)
                                     for _ in range(B)]).astype(np.int32)}
    want = jtf.embed_tokens(jparams, jcfg, _jb(batch))
    tb = {k: _t(v) for k, v in batch.items()}
    got = ttf.embed_tokens(tparams, tcfg, tb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = np.arange(B)[:, None]
    np.testing.assert_array_equal(got.numpy()[rows, batch["vision_pos"]],
                                  batch["vision_embeds"])
    # without vision inputs the VLM embeds like a dense model
    plain = ttf.embed_tokens(tparams, tcfg, {"tokens": tb["tokens"]})
    assert torch.equal(plain, tparams["embed"][tb["tokens"].long()])

    w = rng.standard_normal(got.shape).astype(np.float32)
    jg = jax.grad(lambda e, v: jnp.sum(jtf.embed_tokens(
        {"embed": e}, jcfg, {**_jb(batch), "vision_embeds": v}) * w),
        argnums=(0, 1))(jparams["embed"], jnp.asarray(batch["vision_embeds"]))
    emb = tparams["embed"].clone().requires_grad_(True)
    vis = tb["vision_embeds"].clone().requires_grad_(True)
    out = ttf.embed_tokens({"embed": emb}, tcfg,
                           {**tb, "vision_embeds": vis})
    tg = torch.autograd.grad((out * _t(w)).sum(), (emb, vis))
    for g, j in zip(tg, jg):
        _close(g, j, EMBED_TOL)


@pytest.mark.parametrize("n_codebooks", [2, 4])
def test_audio_embed_and_unembed_match_reference(n_codebooks):
    jcfg, tcfg, jparams, tparams = _setup(AUDIO, n_codebooks=n_codebooks)
    b = _batch(tcfg, 2, 7, seed=4)
    want = jtf.embed_tokens(jparams, jcfg, _jb(b))
    got = ttf.embed_tokens(tparams, tcfg, {"tokens": _t(b["tokens"])})
    assert got.shape == (2, 7, tcfg.d_model)
    if n_codebooks == 2:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want, EMBED_TOL)
    h = np.random.default_rng(5).standard_normal((2, 3, 64)).astype(
        np.float32)
    want = jtf.unembed(jparams, jcfg, jnp.asarray(h))
    got = ttf.unembed(tparams, tcfg, _t(h))
    assert got.shape == (2, 3, n_codebooks, tcfg.padded_vocab)
    _close(got, want, MODEL_TOL)


def test_audio_unembed_masks_the_padded_vocab():
    jcfg, tcfg, jparams, tparams = _setup(AUDIO, vocab_size=50)
    assert tcfg.padded_vocab == 128
    h = np.random.default_rng(6).standard_normal((2, 3, 64)).astype(
        np.float32)
    got = ttf.unembed(tparams, tcfg, _t(h))
    _close(got, jtf.unembed(jparams, jcfg, jnp.asarray(h)), MODEL_TOL)
    assert bool((got[..., 50:] == -1e30).all())


@pytest.mark.parametrize("arch", NEW_ARCHES)
def test_init_params_has_the_reference_layout(arch):
    jcfg, tcfg = _configs(arch, n_layers=2)
    want = jtf.init_params(jcfg, jax.random.key(0))
    got = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jl, _ = jax.tree_util.tree_flatten_with_path(want)
    tl, _ = jax.tree_util.tree_flatten_with_path(got)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
    if arch == AUDIO:  # K tables and K heads
        K, V, D = tcfg.n_codebooks, tcfg.padded_vocab, tcfg.d_model
        assert got["embed"].shape == (K, V, D)
        assert got["lm_head"].shape == (K, D, V)
    assert abs(float(got["embed"].std()) - 0.02) < 0.002


@pytest.mark.parametrize("arch", NEW_ARCHES)
def test_cache_layout_matches_reference(arch):
    jcfg, tcfg = _configs(arch, n_layers=2)
    for dt in ("bfloat16", "int8"):
        want = jinit_cache(jcfg, 2, 16, dt)
        got = init_cache(tcfg, 2, 16, dt, device="cpu")
        for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert cache_bytes(got) == jcache_bytes(want)


# ---------------------------------------------------------------------------
# the models: train forward, prefill, decode, generate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", NEW_ARCHES)
def test_forward_train_logits_match_reference(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    b = _batch(tcfg, 2, 12, seed=1)
    want = jtf.forward(jparams, jcfg, _jb(b), mode="train",
                       logits_mode="all")
    got = ttf.forward(tparams, tcfg, b, mode="train", logits_mode="all")
    assert got.caches is None
    _close(got.logits, want.logits, MODEL_TOL, "logits")
    _close(got.hidden, want.hidden, MODEL_TOL, "hidden")


@pytest.mark.parametrize("arch", NEW_ARCHES)
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("attn_impl", ["blocked", "flash"])
def test_prefill_and_decode_match_reference(monkeypatch, arch, cache_dtype,
                                            attn_impl):
    monkeypatch.setenv("REPRO_PALLAS_FLASH_ATTENTION", "interpret")
    jcfg, tcfg, jparams, tparams = _setup(arch, seed=2)
    b = _batch(tcfg, 2, 13, seed=2)
    pre_b, last = _prefix(b, 12), b["tokens"][..., 12:]
    jpre = jengine.prefill(jparams, jcfg, _jb(pre_b), cache_len=16,
                           cache_dtype=cache_dtype, attn_impl=attn_impl)
    tpre = tengine.prefill(tparams, tcfg, pre_b, cache_len=16,
                           cache_dtype=cache_dtype, attn_impl=attn_impl)
    _close(tpre.logits, jpre.logits, MODEL_TOL, "prefill logits")
    _check_caches(tpre.caches, jpre.caches, cache_dtype)

    # decode from the reference's cache, carried across (decode positions
    # are the cache index, in all three M-RoPE components)
    cache = caches_from_numpy(_np_tree(jpre.caches), "cpu")
    jdec = jengine.decode_step(jparams, jcfg, {"tokens": jnp.asarray(last)},
                               jpre.caches, jnp.int32(12))
    tdec = tengine.decode_step(tparams, tcfg, {"tokens": last}, cache, 12)
    want_shape = ((2, 1, tcfg.n_codebooks, tcfg.padded_vocab)
                  if arch == AUDIO else (2, 1, tcfg.padded_vocab))
    assert tuple(tdec.logits.shape) == want_shape
    _close(tdec.logits, jdec.logits, MODEL_TOL, "decode logits")
    assert tdec.caches is cache  # written in place
    _check_caches(tdec.caches, jdec.caches, cache_dtype)


@pytest.mark.parametrize("arch", NEW_ARCHES)
def test_prefill_then_decode_matches_full_forward(arch):
    """The reference's serving check on the port alone, float32 cache."""
    _, tcfg, _, tparams = _setup(arch, seed=3)
    b = _batch(tcfg, 2, 13, seed=3)
    full = ttf.forward(tparams, tcfg, b, mode="train", logits_mode="last")
    pre = tengine.prefill(tparams, tcfg, _prefix(b, 12), cache_len=16,
                          cache_dtype="float32")
    dec = tengine.decode_step(tparams, tcfg,
                              {"tokens": b["tokens"][..., 12:]},
                              pre.caches, 12)
    _close(dec.logits[:, -1], full.logits[:, -1], MODEL_TOL)


@pytest.mark.parametrize("arch", NEW_ARCHES)
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_generate_matches_reference_engine(arch, cache_dtype):
    jcfg, tcfg, jparams, tparams = _setup(arch, seed=4)
    prompt = _batch(tcfg, 2, 9, seed=4)
    want = jengine.LMServingEngine(
        jparams, jcfg, batch=2, cache_len=20, cache_dtype=cache_dtype
    ).generate(_jb(prompt), n_steps=6)
    got = tengine.LMServingEngine(
        tparams, tcfg, batch=2, cache_len=20, cache_dtype=cache_dtype
    ).generate(prompt, n_steps=6)
    shape = (2, tcfg.n_codebooks, 6) if arch == AUDIO else (2, 6)
    assert got.tokens.shape == shape and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_lm_loss_matches_reference_on_the_new_batches(arch):
    """The train CLI's batch layout (accumulation axis first; the VLM's
    float32 patch embeddings at distinct slots) through the port's and
    the reference's lm_loss, microbatch 0."""
    jcfg, tcfg, jparams, tparams = _setup(arch, seed=5)
    books = tcfg.n_codebooks if tcfg.family == "audio" else 0
    item = next(synthetic_token_stream(tcfg.vocab_size, 16, 4, seed=0,
                                       n_codebooks=books))
    batch = ttrain.train_batch(tcfg, item, 16)
    lead = (ttrain.ACCUM, 2)
    assert batch["tokens"].shape[:2] == lead
    if arch == VLM:
        assert batch["vision_embeds"].shape == lead + (4, tcfg.d_model)
        pos = batch["vision_pos"]
        for a in range(lead[0]):  # distinct slots in every row
            for r in range(lead[1]):
                assert len(set(pos[a, r])) == pos.shape[-1]
    mb = {k: v[0] for k, v in batch.items()}
    jl = jtr.lm_loss(jparams, jcfg, JParallelConfig(logit_chunk=8),
                     _jb(mb))[0]
    tl = ttr.lm_loss(tparams, tcfg, ParallelConfig(logit_chunk=8),
                     {k: _t(v) for k, v in mb.items()})[0]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


# ---------------------------------------------------------------------------
# decode_attention_ref
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_decode_attention_ref_matches_reference(masked):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 3, 1, 16)).astype(np.float32)
    k = rng.standard_normal((2, 3, 10, 16)).astype(np.float32)
    v = rng.standard_normal((2, 3, 10, 16)).astype(np.float32)
    mask = (np.arange(10)[None, :] < np.array([[7], [10]])) if masked \
        else None
    want = jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask))
    got = tref.decode_attention_ref(_t(q), _t(k), _t(v),
                                    None if mask is None else _t(mask))
    _close(got, want, LAYER_TOL)
    if masked:  # slots past a row's length take no weight
        v2 = v.copy()
        v2[0, :, 7:] = 1e3
        again = tref.decode_attention_ref(_t(q), _t(k), _t(v2), _t(mask))
        assert torch.equal(again[0], got[0])
    else:  # the last row of causal attention over the whole cache
        full = tref.attention_ref(_t(q), _t(k), _t(v), causal=True,
                                  q_offset=9)
        _close(got, full.numpy(), LAYER_TOL)


# ---------------------------------------------------------------------------
# the CLIs and carrying weights across
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_serve_cli_runs_on_the_cpu(capsys, arch):
    out = tserve.main(["--arch", arch, "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    shape = (2, 2, 3) if arch == AUDIO else (2, 3)
    assert out.tokens.shape == shape
    assert "on cpu" in capsys.readouterr().out


def test_serve_cli_prompt_matches_the_reference_draws():
    """The VLM's prompt: the reference CLI's numpy draws in its order."""
    _, tcfg = _configs(VLM)
    got = tserve.prompt_batch(tcfg, 2, 8, "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, (2, 8))
    vis = rng.normal(size=(2, 4, tcfg.d_model)).astype(np.float32)
    pos = np.stack([rng.choice(8, size=4, replace=False) for _ in range(2)])
    np.testing.assert_array_equal(got["tokens"].numpy(), toks)
    np.testing.assert_array_equal(got["vision_embeds"].numpy(), vis)
    np.testing.assert_array_equal(got["vision_pos"].numpy(), pos)
    with pytest.raises(ValueError, match="vision tokens"):
        tserve.prompt_batch(tcfg, 2, 3, "cpu")


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_train_cli_runs_on_the_cpu(tmp_path, capsys, arch):
    state, loop = ttrain.main(["--arch", arch, "--reduced", "--seq", "16",
                               "--batch", "4", "--steps", "3", "--ckpt",
                               str(tmp_path / "ck"), "--device", "cpu"])
    assert int(state.step) == 3 and len(loop.records) == 3
    assert all(np.isfinite(r.metrics["loss"]) for r in loop.records)
    assert "on cpu" in capsys.readouterr().out


def test_lm_params_from_numpy_carries_the_audio_tree():
    jcfg, tcfg = _configs(AUDIO, n_layers=2, dtype="bfloat16")
    tree = _np_tree(jtf.init_params(jcfg, jax.random.key(0)))
    got = lm_params_from_numpy(tree, "cpu")
    K, V, D = tcfg.n_codebooks, tcfg.padded_vocab, tcfg.d_model
    assert got["embed"].shape == (K, V, D)
    assert got["lm_head"].shape == (K, D, V)
    for a, t in zip(jax.tree_util.tree_leaves(tree), tree_leaves(got)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    b = _batch(tcfg, 2, 5, seed=8)
    out = ttf.forward(got, tcfg, b, mode="prefill", cache_len=8)
    assert out.logits.shape == (2, 1, K, V)
