"""The port's LM training (`repro_torch`) against `repro`, on the CPU.

The same inputs go through both packages: parameters and train states
from the reference's `init_params` / `init_train_state` (`jax.random`
draws cannot be made in torch), carried across by `convert.py`; tokens,
attention inputs and gradients drawn with numpy from fixed seeds. The
configs are the reduced qwen3-8b (qk-norm, GQA), qwen2.5-3b (tied
embeddings, qkv bias) and chatglm3-6b (partial rotary) at 2 layers, in
float32.

Tolerances, stated once:
  * the blocked attention's forward and its custom backward (dq, dk, dv):
    within 1e-5 of the reference's `_flash_attn` and its VJP (float32
    einsums summed in another order), and of autograd through a
    materialized softmax in float64; the forward is bit-equal to the
    parent's (a copy of it is kept here);
  * losses within rtol 1e-5; gradients within 1e-5 of each leaf's
    largest magnitude (`tests/test_torch_training.py`);
  * the train step, 5 steps each run from the reference's state after
    the step before (carried across): loss, grad norm and lr within rtol
    1e-5 (the grad norm 5e-5 with compression: it is the compressed
    gradient's, where an entry on a rounding boundary lands one int8
    step apart); parameters within 1e-6 in all but 0.1% of entries and
    within 1e-3 (a tenth of lr) everywhere, since AdamW divides by
    sqrt(v) + eps and a last-bit difference of a gradient entry near
    eps moves its update by a fraction of lr (ROADMAP C.4); the error
    buffer within 1e-6 in all but 0.1% of entries, the rest at most one
    int8 step (below 2e-2 for these gradients) apart;
  * the same 5 steps chained on the port's own state, float32 states
    without compression: per-step loss within rtol 1e-5, parameters
    within 1e-6 in all but 0.5% of entries and within 5e-3 (half the
    lr) everywhere. With int8 states or compression the two
    trajectories part after a step or two: one entry a rounding step
    apart changes that entry's next update by up to lr, the next
    forward moves every gradient's last bits, and more entries cross a
    boundary; each step stays held from the reference's state above.
Inside the port, compression and the token stream are held bit for bit,
and the loop's restart too.
"""
import datetime
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ParallelConfig as JParallelConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import active_param_count as jactive_param_count
from repro.configs.reduced import reduce_config as jreduce
from repro.configs.registry import get_arch as jget_arch
from repro.core import lsh as jlsh
from repro.core import quantization as jq
from repro.data import lm_data as jlm_data
from repro.distributed import training as jtr
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.optim import compression as jcomp
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import base as tbase
from repro_torch.configs.reduced import reduce_config
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.core import lsh as tlsh
from repro_torch.core import quantization as tq
from repro_torch.data import lm_data
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed import training as ttr
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw
from repro_torch.optim import compression as tcomp
from repro_torch.utils import tree_leaves, tree_map

ATTN_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
PARAM_ATOL = 1e-6
SRC = Path(__file__).resolve().parents[1] / "src"
JOIN_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The steps here are many small eager ops: one intra-op thread runs
    them fastest, and keeps this file from contending for the cores with
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(arch, **kw):
    jcfg = jreduce(jget_arch(arch).model).with_(n_layers=2, **kw)
    tcfg = reduce_config(get_arch(arch).model).with_(n_layers=2, **kw)
    return jcfg, tcfg


def _bias(tree, seed):
    """The reference inits qkv biases to zero: make them nonzero."""
    rng = np.random.default_rng(seed)
    attn = tree["layers"]["attn"]
    for name in ("wq", "wk", "wv"):
        if "b" in attn[name]:
            b = attn[name]["b"]
            attn[name]["b"] = (0.1 * rng.standard_normal(b.shape)).astype(
                b.dtype)
    return tree


def _params(jcfg, seed=0):
    return _bias(_np_tree(jtf.init_params(jcfg, jax.random.key(seed))), seed)


def _lm_batch(vocab, accum, mb, S, seed=0):
    """The reference tests' structured batch (odd tokens = even + 1)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (accum, mb, S + 1))
    toks[..., 1::2] = (toks[..., 0::2][..., : toks[..., 1::2].shape[-1]]
                       + 1) % vocab
    return {"tokens": toks[..., :-1].astype(np.int32),
            "labels": toks[..., 1:].astype(np.int32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _assert_grads(tgrads, jgrads):
    got, want = tree_leaves(tgrads), [np.asarray(x) for x in
                                      jax.tree_util.tree_leaves(jgrads)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max())


def _assert_params(tparams, jparams, frac=0.001, most=1e-3):
    """Within `PARAM_ATOL` in all but `frac` of entries, `most` in all."""
    got = np.concatenate([t.float().numpy().ravel()
                          for t in tree_leaves(tparams)])
    want = np.concatenate([np.asarray(w, np.float32).ravel() for w in
                           jax.tree_util.tree_leaves(jparams)])
    diff = np.abs(got - want)
    assert (diff > PARAM_ATOL).mean() <= frac, (diff > PARAM_ATOL).sum()
    assert diff.max() <= most, diff.max()


# ---------------------------------------------------------------------------
# the blocked attention: forward bits and the custom backward
# ---------------------------------------------------------------------------
def _parent_blocked_forward(q5, k, v, *, causal=True, q_offset=0,
                            block_k=1024):
    """The blocked forward as it was before the custom backward, kept
    verbatim: the prefill path must keep its bits."""
    B, R, G, Sq, hd = q5.shape
    Sk = k.shape[2]
    dev = q5.device
    qf = q5.float() * hd**-0.5
    rows = torch.arange(Sq, device=dev)[:, None] + q_offset
    m = torch.full((B, R, G, Sq), float("-inf"), device=dev)
    l = torch.zeros((B, R, G, Sq), device=dev)
    acc = torch.zeros((B, R, G, Sq, hd), device=dev)
    for lo in range(0, Sk, min(block_k, Sk)):
        kb = k[:, :, lo:lo + block_k].float()
        vb = v[:, :, lo:lo + block_k].float()
        s = torch.einsum("brgqd,brkd->brgqk", qf, kb)
        cols = lo + torch.arange(kb.shape[2], device=dev)[None, :]
        masked = (cols > rows) if causal else torch.zeros_like(
            cols, dtype=torch.bool)
        s.masked_fill_(masked, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp_(s.sub_(m_safe[..., None])).masked_fill_(masked, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("brgqk,brkd->brgqd", p,
                                                    vb)
        m = m_safe
    return acc / l.clamp_min(1e-30)[..., None]


# (B, R, G, Sq, Sk, hd, causal, q_offset, block_k): causal; a causal
# offset (a later query block); Sk not a multiple of block_k; GQA with
# R > 1 and G > 1, and R = 1; non-causal with a ragged last block
ATTN_CASES = [
    (2, 2, 2, 32, 32, 16, True, 0, 8),
    (1, 2, 2, 8, 40, 16, True, 32, 16),
    (2, 2, 2, 37, 37, 16, True, 0, 16),
    (1, 1, 4, 24, 24, 8, True, 0, 1024),
    (2, 3, 2, 11, 29, 16, False, 0, 8),
]


def _attn_inputs(B, R, G, Sq, Sk, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, R, G, Sq, hd)).astype(np.float32),
            rng.standard_normal((B, R, Sk, hd)).astype(np.float32),
            rng.standard_normal((B, R, Sk, hd)).astype(np.float32),
            rng.standard_normal((B, R, G, Sq, hd)).astype(np.float32))


def _attn_grads(q, k, v, dout, **kw):
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tattn.gqa_blocked_attention(q, k, v, **kw)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), torch.from_numpy(dout))
    return out.detach(), dq, dk, dv


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_backward_matches_reference_vjp(case):
    B, R, G, Sq, Sk, hd, causal, off, bk = case
    q, k, v, dout = _attn_inputs(B, R, G, Sq, Sk, hd)
    want_out, vjp = jax.vjp(
        lambda a, b, c: jattn._flash_attn(a, b, c, causal, off, bk),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    got_out, *got = _attn_grads(q, k, v, dout, causal=causal, q_offset=off,
                                block_k=bk)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=ATTN_TOL,
                                   atol=ATTN_TOL, err_msg=name)


def _materialized(q5, k, v, causal, q_offset):
    hd = q5.shape[-1]
    s = torch.einsum("brgqd,brkd->brgqk", q5, k) * hd**-0.5
    if causal:
        rows = torch.arange(q5.shape[3])[:, None] + q_offset
        s = s.masked_fill(torch.arange(k.shape[2])[None, :] > rows,
                          float("-inf"))
    return torch.einsum("brgqk,brkd->brgqd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_backward_matches_materialized_autograd(case):
    """Against autograd through the (Sq, Sk) softmax, in float64."""
    B, R, G, Sq, Sk, hd, causal, off, bk = case
    q, k, v, dout = _attn_inputs(B, R, G, Sq, Sk, hd, seed=1)
    got_out, *got = _attn_grads(q, k, v, dout, causal=causal, q_offset=off,
                                block_k=bk)
    q64, k64, v64 = (torch.from_numpy(x).double().requires_grad_(True)
                     for x in (q, k, v))
    out = _materialized(q64, k64, v64, causal, off)
    want = torch.autograd.grad(out, (q64, k64, v64),
                               torch.from_numpy(dout).double())
    np.testing.assert_allclose(got_out.numpy(), out.detach().numpy(),
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=ATTN_TOL,
                                   atol=ATTN_TOL)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_blocked_forward_keeps_the_parents_bits(case):
    """Prefill (no grad) and the training forward give the parent's bits."""
    B, R, G, Sq, Sk, hd, causal, off, bk = case
    q, k, v, _ = _attn_inputs(B, R, G, Sq, Sk, hd, seed=2)
    kw = dict(causal=causal, q_offset=off, block_k=bk)
    want = _parent_blocked_forward(*map(torch.from_numpy, (q, k, v)), **kw)
    with torch.no_grad():
        got = tattn.gqa_blocked_attention(*map(torch.from_numpy, (q, k, v)),
                                          **kw)
    assert torch.equal(got, want)
    got_train = _attn_grads(q, k, v, np.ones_like(q), **kw)[0]
    assert torch.equal(got_train, want)


def test_attention_saves_only_o_s_hd():
    """The custom backward saves (q5, k, v, out, lse), never an (Sq, Sk)
    block of probabilities."""
    q, k, v, _ = _attn_inputs(1, 2, 2, 64, 64, 16)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tattn.gqa_blocked_attention(qt, kt, vt, block_k=16)
    assert sorted(saved) == sorted([q.shape, k.shape, v.shape, q.shape,
                                    q.shape[:-1]])


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,chunk", [(128, 4), (100, 8), (100, 0)])
def test_chunked_cross_entropy_matches_reference(vocab, chunk):
    """Chunked equals unchunked and the reference, with a vocab that is
    not a multiple of 128 (a -1e30 tail in the padded logits); gradients
    with respect to the hidden states and the unembedding too."""
    jcfg, tcfg = _configs("qwen2.5-3b", vocab_size=vocab)
    tree = _params(jcfg)
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, vocab, (2, 16)).astype(np.int32)
    jfn = jax.value_and_grad(
        lambda p, h: jtr.chunked_cross_entropy(p, jcfg, h,
                                               jnp.asarray(labels), chunk),
        argnums=(0, 1))
    jl, (jgp, jgh) = jfn(jax.tree_util.tree_map(jnp.asarray, tree),
                         jnp.asarray(hidden))
    tparams = lm_params_from_numpy(tree, "cpu")
    fn = ttr.value_and_grad(lambda ph, lab: ttr.chunked_cross_entropy(
        ph["p"], tcfg, ph["h"], lab, chunk))
    tl, tg = fn({"p": tparams, "h": torch.from_numpy(hidden)},
                torch.from_numpy(labels))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    _assert_grads(tg["h"], jgh)
    _assert_grads(tg["p"]["embed"], jgp["embed"])
    full = ttr.chunked_cross_entropy(tparams, tcfg,
                                     torch.from_numpy(hidden),
                                     torch.from_numpy(labels), 0)
    np.testing.assert_allclose(float(tl), float(full), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("remat", ["none", "block"])
def test_lm_loss_and_grads_match_reference(arch, remat):
    jcfg, tcfg = _configs(arch)
    tree = _params(jcfg, seed=3)
    pj = JParallelConfig(remat=remat, logit_chunk=8)
    pt = tbase.ParallelConfig(remat=remat, logit_chunk=8)
    mb = {k: v[0] for k, v in _lm_batch(jcfg.vocab_size, 1, 2, 16).items()}
    jl, jg = jax.value_and_grad(lambda p: jtr.lm_loss(p, jcfg, pj,
                                                      _jb(mb))[0])(
        jax.tree_util.tree_map(jnp.asarray, tree))
    tl, tg = ttr.value_and_grad(
        lambda p, b: ttr.lm_loss(p, tcfg, pt, b)[0])(
        lm_params_from_numpy(tree, "cpu"), _tb(mb))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    _assert_grads(tg, jg)


def test_train_forward_has_grad_and_serving_does_not():
    _, tcfg = _configs("qwen3-8b")
    params = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tracked = tree_map(lambda t: t.detach().requires_grad_(True), params)
    toks = {"tokens": np.zeros((1, 8), np.int32)}
    out = ttf.forward(tracked, tcfg, toks, mode="train")
    assert out.hidden.requires_grad and float(out.aux_loss) == 0.0
    pre = ttf.forward(tracked, tcfg, toks, mode="prefill", cache_len=12)
    assert not pre.logits.requires_grad
    assert not pre.caches.k.requires_grad
    with pytest.raises(ValueError, match="remat"):
        ttf.forward(params, tcfg, toks, mode="train", remat="full")


def test_token_embedding_backward_is_deterministic():
    """Repeated ids: the gather's gradient is the same bits every run."""
    _, tcfg = _configs("qwen3-8b")
    params = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 4, (4, 64)).astype(np.int32)  # many repeats
    fn = ttr.value_and_grad(lambda p, b: ttf.forward(
        p, tcfg, b, mode="train").hidden.float().square().mean())
    g1 = fn(params, {"tokens": toks})[1]["embed"]
    for _ in range(3):
        assert torch.equal(fn(params, {"tokens": toks})[1]["embed"], g1)


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------
# (arch, accum, remat, opt_state_dtype, grad_compression): every value of
# each variant meets every arch and every other variant's values
STEP_CASES = [
    ("qwen3-8b", 1, "none", "float32", False),
    ("qwen3-8b", 2, "block", "int8", True),
    ("qwen2.5-3b", 2, "none", "float32", True),
    ("qwen2.5-3b", 1, "block", "int8", False),
    ("chatglm3-6b", 2, "block", "float32", False),
    ("chatglm3-6b", 1, "none", "int8", True),
]


@pytest.mark.parametrize("arch,accum,remat,state_dtype,comp", STEP_CASES)
def test_train_step_matches_reference(arch, accum, remat, state_dtype,
                                      comp):
    """5 steps, each from the reference's state carried across; and, on
    float32 states without compression, the port's own 5 chained steps
    from the reference's `init_train_state`."""
    jcfg, tcfg = _configs(arch)
    kw = dict(remat=remat, logit_chunk=8, grad_accum={"tiny": accum},
              opt_state_dtype=state_dtype, grad_compression=comp)
    pj, pt = JParallelConfig(**kw), tbase.ParallelConfig(**kw)
    js = jtr.init_train_state(jcfg, pj, jax.random.key(0))
    chain = train_state_from_numpy(_np_tree(js), "cpu")
    assert (chain.err_buf is None) == (not comp)
    chained = state_dtype == "float32" and not comp
    sched = dict(base_lr=1e-2, warmup=2, total_steps=20)
    jstep = jax.jit(jtr.make_train_step(jcfg, pj, JShapeConfig(
        "tiny", "train", 16, 2 * accum), **sched))
    tstep = ttr.make_train_step(tcfg, pt, tbase.ShapeConfig(
        "tiny", "train", 16, 2 * accum), **sched)
    rtol = {"loss": LOSS_RTOL, "lr": LOSS_RTOL,
            "grad_norm": 5 * LOSS_RTOL if comp else LOSS_RTOL}
    for i in range(5):
        batch = _lm_batch(jcfg.vocab_size, accum, 2, 16, seed=10 + i)
        ts = train_state_from_numpy(_np_tree(js), "cpu")
        js, jm = jstep(js, _jb(batch))
        ts, tm = tstep(ts, batch)
        for key, tol in rtol.items():
            assert tm[key].shape == ()
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=tol, err_msg=f"{key} {i}")
        _assert_params(ts.params, js.params)
        if comp:
            _assert_params(ts.err_buf, js.err_buf, most=2e-2)
        if chained:
            chain, cm = tstep(chain, batch)
            np.testing.assert_allclose(float(cm["loss"]), float(jm["loss"]),
                                       rtol=LOSS_RTOL, err_msg=f"chain {i}")
    assert int(ts.step) == int(js.step) == 5
    if chained:
        assert int(chain.step) == 5
        _assert_params(chain.params, js.params, frac=0.005, most=5e-3)


# ---------------------------------------------------------------------------
# the reference's tests/test_training.py contracts, on the port alone
# ---------------------------------------------------------------------------
def _tiny(accum=2, logit_chunk=8):
    cfg = reduce_config(get_arch("qwen2.5-3b").model).with_(n_layers=2)
    pcfg = tbase.ParallelConfig(remat="block", logit_chunk=logit_chunk,
                                grad_accum={"tiny": accum},
                                opt_state_dtype="float32")
    return cfg, pcfg, tbase.ShapeConfig("tiny", "train", 16, 4)


def _state(cfg, pcfg):
    return ttr.init_train_state(cfg, pcfg, torch.Generator().manual_seed(0),
                                "cpu")


def test_chunked_ce_matches_unchunked():
    cfg, _, _ = _tiny()
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    hidden = torch.from_numpy(rng.normal(size=(2, 16, cfg.d_model))
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    full = ttr.chunked_cross_entropy(params, cfg, hidden, labels, 0)
    chunked = ttr.chunked_cross_entropy(params, cfg, hidden, labels, 4)
    np.testing.assert_allclose(float(full), float(chunked), rtol=1e-5)


def test_train_step_reduces_loss_on_learnable_data():
    """remat + accumulation + chunked CE + AdamW end to end."""
    cfg, pcfg, shape = _tiny()
    state = _state(cfg, pcfg)
    step = ttr.make_train_step(cfg, pcfg, shape, base_lr=1e-2, warmup=2,
                               total_steps=80)
    losses = []
    for i in range(60):
        state, metrics = step(state, _lm_batch(cfg.vocab_size, 2, 4, 32,
                                               seed=i))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::10]
    assert int(state.step) == 60


def test_accum_equals_bigger_batch():
    cfg, pcfg1, _ = _tiny(accum=1)
    pcfg2 = pcfg1.with_(grad_accum={"tiny": 2})
    shape = tbase.ShapeConfig("tiny", "train", 16, 4)
    batch = _lm_batch(cfg.vocab_size, 2, 2, 16)
    merged = {k: v.reshape(1, 4, 16) for k, v in batch.items()}
    s1, m1 = ttr.make_train_step(cfg, pcfg1, shape)(_state(cfg, pcfg1),
                                                    merged)
    s2, m2 = ttr.make_train_step(cfg, pcfg2, shape)(_state(cfg, pcfg1),
                                                    batch)
    for w1, w2 in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(w1.numpy(), w2.numpy(), rtol=1e-4,
                                   atol=1e-5)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)


def _run_variant(pcfg, n_steps=45, lr=1e-2):
    cfg, _, shape = _tiny(accum=1)
    state = _state(cfg, pcfg)
    step = ttr.make_train_step(cfg, pcfg, shape, base_lr=lr, warmup=2,
                               total_steps=n_steps + 5)
    losses = []
    for i in range(n_steps):
        state, metrics = step(state, _lm_batch(cfg.vocab_size, 1, 8, 32,
                                               seed=100 + i))
        losses.append(float(metrics["loss"]))
    return state, losses


@pytest.fixture(scope="module")
def f32_run():
    _, pcfg, _ = _tiny(accum=1)
    return pcfg, _run_variant(pcfg)[1]


def test_grad_compression_tracks_uncompressed(f32_run):
    pcfg, base = f32_run
    state_c, comp = _run_variant(pcfg.with_(grad_compression=True))
    assert state_c.err_buf is not None
    assert base[-1] < base[0] - 0.2, base[::9]
    assert comp[-1] < comp[0] - 0.2, comp[::9]
    assert abs(comp[-1] - base[-1]) < 0.25, (base[-1], comp[-1])


def test_int8_opt_state_tracks_fp32(f32_run):
    pcfg, fp32 = f32_run
    state, int8 = _run_variant(pcfg.with_(opt_state_dtype="int8"))
    assert isinstance(state.opt.mu["embed"], adamw.QuantState)
    assert fp32[-1] < fp32[0] - 0.2, fp32[::9]
    assert int8[-1] < int8[0] - 0.2, int8[::9]
    assert abs(int8[-1] - fp32[-1]) < 0.25, (fp32[-1], int8[-1])


# ---------------------------------------------------------------------------
# train states carried across, and the entry points' device
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,state_dtype,comp", [
    ("bfloat16", "float32", True), ("bfloat16", "bfloat16", False),
    ("float32", "int8", False)])
def test_train_state_from_reference_is_bit_equal(dtype, state_dtype, comp):
    jcfg, _ = _configs("qwen3-8b", dtype=dtype)
    js = _np_tree(jtr.init_train_state(jcfg, JParallelConfig(
        opt_state_dtype=state_dtype, grad_compression=comp),
        jax.random.key(0)))
    ts = train_state_from_numpy(js, "cpu")

    def bits(x):
        a = np.asarray(x)
        return a.view(np.int16) if a.dtype.name == "bfloat16" else a

    def tbits(t):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()

    want = jax.tree_util.tree_leaves(js)
    got = tree_leaves([ts.params, [[q.values, q.scales] if isinstance(
        q, adamw.QuantState) else q for q in tree_leaves(ts.opt.mu)],
        [[q.values, q.scales] if isinstance(q, adamw.QuantState) else q
         for q in tree_leaves(ts.opt.nu)], ts.opt.count, ts.step,
        ts.err_buf])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(tbits(g), bits(w))
    assert (ts.err_buf is None) == (not comp)
    assert tree_leaves(ts.params)[0].dtype == getattr(torch, dtype)


def test_init_train_state_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a GPU")
    cfg, pcfg, _ = _tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.init_train_state(cfg, pcfg, torch.Generator())


def test_shapes_and_active_params_equal_the_reference():
    assert {k: tuple(v.__dict__.values()) for k, v in tbase.SHAPES.items()} \
        == {k: tuple(v.__dict__.values()) for k, v in JSHAPES.items()}
    for arch in ARCH_IDS:
        assert tbase.active_param_count(get_arch(arch).model) == \
            jactive_param_count(jget_arch(arch).model)
    moe = jget_arch("phi3.5-moe-42b-a6.6b").model
    fields = {f: getattr(moe, f) for f in moe.__dataclass_fields__}
    assert tbase.active_param_count(tbase.ModelConfig(**fields)) == \
        jactive_param_count(moe)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------
def _grad_tree(rng):
    return {"w": (rng.standard_normal((6, 40)) * 10.0 ** rng.integers(
        -6, 1, (6, 40))).astype(np.float32),
        "layers": [{"b": rng.standard_normal((3, 17)).astype(np.float32)}],
        "zero_row": np.zeros((2, 8), np.float32),
        "s": np.float32(0.5)}


def test_compress_decompress_bit_equal_to_reference():
    """Five error-feedback rounds: g_hat and the buffer bit for bit; the
    0-d leaf passes through."""
    rng = np.random.default_rng(0)
    grads = [_grad_tree(rng) for _ in range(5)]
    jerr = jcomp.init_error_buffer(jax.tree_util.tree_map(jnp.asarray,
                                                          grads[0]))
    terr = tcomp.init_error_buffer(tree_map(torch.from_numpy,
                                            tree_map(np.asarray, grads[0])))
    for g in grads:
        jg, jerr = jcomp.compress_decompress(
            jax.tree_util.tree_map(jnp.asarray, g), jerr)
        tg, terr = tcomp.compress_decompress(
            tree_map(lambda a: torch.from_numpy(np.asarray(a)), g), terr)
        for got, want in zip(tree_leaves(tg) + tree_leaves(terr),
                             jax.tree_util.tree_leaves(jg)
                             + jax.tree_util.tree_leaves(jerr)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(tg["s"]) == 0.5


def test_rowwise_scale_floor_is_its_own():
    """1e-12, not the table format's 1e-8: a row of 1e-9 survives."""
    x = torch.full((1, 4), 1e-9)
    q, scale = tcomp._rowwise_q(x)
    assert torch.equal(q, torch.full((1, 4), 127, dtype=torch.int8))
    assert float(scale) == pytest.approx(1e-9 / 127)


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def test_compressed_psum_one_rank_matches_reference(one_rank):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    mesh = jax.make_mesh((1,), ("data",))
    want = jax.shard_map(lambda a: jcomp.compressed_psum(a, "data"),
                         mesh=mesh, in_specs=jax.sharding.PartitionSpec(),
                         out_specs=jax.sharding.PartitionSpec(),
                         check_vma=False)(jnp.asarray(x))
    got = tcomp.compressed_psum(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


RANK_SCRIPT = """
import datetime, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.optim.compression import compressed_psum
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
x = np.load(f"{d}/inputs.npy")[rank]
np.save(f"{d}/out{rank}.npy", compressed_psum(torch.from_numpy(x)).numpy())
assert "jax" not in sys.modules
dist.destroy_process_group()
"""


def test_compressed_psum_two_ranks(tmp_path):
    """Two gloo ranks, each its own process: both get the same bits, the
    sum in rank order of the reference's per-rank int8 contributions."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 32)).astype(np.float32)
    np.save(tmp_path / "inputs.npy", x)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p)}
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r),
                               "2", str(tmp_path)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=JOIN_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    contrib = []
    for r in range(2):
        q, scale = jcomp._rowwise_q(jnp.asarray(x[r]))
        contrib.append(np.asarray(q.astype(jnp.float32) * scale))
    want = contrib[0] + contrib[1]
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"out{r}.npy"),
                                      want)


# ---------------------------------------------------------------------------
# the token pipeline and the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_codebooks", [0, 2])
def test_synthetic_token_stream_bit_equal_to_reference(n_codebooks):
    want = jlm_data.synthetic_token_stream(100, 17, 3, seed=5,
                                           n_codebooks=n_codebooks)
    got = lm_data.synthetic_token_stream(100, 17, 3, seed=5,
                                         n_codebooks=n_codebooks)
    for _ in range(4):
        w, g = next(want), next(got)
        assert g["step"] == w["step"]
        for k in ("tokens", "labels"):
            assert g[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])


def test_prefetch_iterator_order_and_errors():
    assert list(lm_data.PrefetchIterator(iter(range(10)), depth=2)) == \
        list(range(10))

    def broken():
        yield 1
        yield 2
        raise ValueError("producer failed")

    it = lm_data.PrefetchIterator(broken(), depth=1)
    assert it.get(timeout=10) == 1 and it.get(timeout=10) == 2
    with pytest.raises(ValueError, match="producer failed"):
        it.get(timeout=10)
    with pytest.raises(ValueError, match="producer failed"):
        it.get(timeout=10)  # and again: the stream stays ended


def test_train_cli_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "qwen3-8b", "--reduced", "--seq", "16", "--batch",
            "4", "--ckpt", str(tmp_path / "ck"), "--checkpoint-every", "2",
            "--device", "cpu"]
    state, loop = ttrain.main(argv + ["--steps", "3"])
    assert int(state.step) == 3 and len(loop.records) == 3
    assert "on cpu" in capsys.readouterr().out
    assert loop.ckpt.latest() == 3
    state, loop = ttrain.main(argv + ["--steps", "5"])
    assert "start=3" in capsys.readouterr().out
    assert int(state.step) == 5 and [r.step for r in loop.records] == [3, 4]


def test_trainloop_restart_is_bit_equal(tmp_path):
    """A hard kill at step 4 after the step-3 checkpoint; the restart
    from step 3 ends bit-equal to an uninterrupted run."""
    cfg, pcfg, shape = _tiny()
    pcfg = pcfg.with_(grad_compression=True, opt_state_dtype="int8")
    policy = ft.FaultPolicy(checkpoint_every=3,
                            straggler_factor=float("inf"))
    batches = [_lm_batch(cfg.vocab_size, 2, 2, 16, seed=i) for i in range(6)]

    def loop(name, hook=None):
        step = ttr.make_train_step(cfg, pcfg, shape, base_lr=1e-2, warmup=2,
                                   total_steps=10)

        def train_step(state, batch):
            return step(state, batch)

        return ft.TrainLoop(train_step, Checkpointer(tmp_path / name),
                            policy, fault_hook=hook)

    ref, end = loop("ref").run(_state(cfg, pcfg), iter(batches), 6)
    assert end == 6

    def bomb(step):
        if step == 4:
            raise KeyboardInterrupt  # a hard kill, not a retryable fault

    with pytest.raises(KeyboardInterrupt):
        loop("crash", bomb).run(_state(cfg, pcfg), iter(batches), 6)
    resumed = loop("crash")
    state, start = resumed.resume_or_init(lambda: _state(cfg, pcfg))
    assert start == 3
    state, end = resumed.run(state, iter(batches[3:]), 6, start_step=3)
    assert end == 6

    def leaves(s):
        return tree_leaves([s.params, [[q.values, q.scales] for q in
                                       tree_leaves(s.opt.mu)],
                            s.opt.count, s.step, s.err_buf])

    for a, b in zip(leaves(ref), leaves(state)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# A.6: the small public functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,block", [((7, 33), 16), ((300,), 256),
                                         ((2, 3, 4), 5), ((0,), 8)])
def test_blockwise_quantization_matches_reference(shape, block):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    want = jq.quantize_blockwise(jnp.asarray(x), block)
    got = tq.quantize_blockwise(torch.from_numpy(x), block)
    assert got.shape == want.shape == tuple(shape)
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(),
                                  np.asarray(want.scales))
    np.testing.assert_array_equal(
        tq.dequantize_blockwise(got).numpy(),
        np.asarray(jq.dequantize_blockwise(want)))


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_symmetric_int8_and_error_bound_match_reference(axis):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((5, 6, 7)).astype(np.float32)
    jv, js = jq.quantize_symmetric_int8(jnp.asarray(x), axis=axis)
    tv, ts = tq.quantize_symmetric_int8(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    rows = x.reshape(-1, 7)
    jrow = jq.quantize_rowwise(jnp.asarray(rows))
    trow = tq.quantize_rowwise(torch.from_numpy(rows))
    bound = tq.rowwise_quant_error_bound(trow)
    np.testing.assert_array_equal(
        bound.numpy(), np.asarray(jq.rowwise_quant_error_bound(jrow)))
    err = (tq.dequantize_rowwise(trow) - torch.from_numpy(rows)).abs()
    assert bool((err <= bound + 1e-7).all())


def test_lsh_helpers_match_reference():
    cos = np.linspace(-1.2, 1.2, 25).astype(np.float32)
    np.testing.assert_allclose(
        tlsh.expected_hamming(torch.from_numpy(cos), 256).numpy(),
        np.asarray(jlsh.expected_hamming(jnp.asarray(cos), 256)),
        rtol=1e-6)
    for n_bits in (1, 32, 33, 250, 256):
        assert tlsh.signature_words(n_bits) == jlsh.signature_words(n_bits)
