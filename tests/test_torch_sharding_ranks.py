"""The port's built LM steps on spawned gloo groups, against the unsharded
port steps (and, for qwen3-8b, the reference's step), on the CPU.

Each group follows `tests/test_torch_mesh.py`: every rank runs this file
as a script (``python tests/test_torch_sharding_ranks.py CASE WORLD RANK
DIR``), joins a `file://` rendezvous in the test's `tmp_path`, asserts it
never loaded `jax`, and writes its outputs; the parent kills every rank on
the first failure and shows its log, and joins within `JOIN_S`. Cases:

- 4 ranks, (data=2, model=2): qwen3-8b (and with `fsdp=True`),
  qwen2-vl-72b and musicgen-large here; phi3.5-moe, llama4-maverick
  (`moe_shard_ff`), mamba2-1.3b and zamba2-1.2b, and the checkpoint
  resharding, in `tests/test_torch_sharding_ranks_b.py`. Each: 2 train
  steps (accumulation 2, `logit_chunk=16`), a prefill and 2 decode steps,
  under the bundle's own `ParallelConfig`.
- 3 ranks, (data=1, model=3): qwen2.5-3b with 6 heads over 2 kv heads of
  24 (`heads_shardable` False: the prefill sequence-sharded, the cache's
  sequence over `model`).
- 8 ranks, (pod=2, data=2, model=2): qwen2.5-3b.

The built steps hold the unsharded port's results within the tolerances
of `tests/test_torch_lm_training.py` (`LOSS_RTOL`; `GRAD_RTOL` and
`MOE_GRAD_TOL` for the trained state's change, whose gradients they
bound) and `tests/test_torch_lm.py` / `tests/test_torch_moe.py`
(`MODEL_TOL` and `MOE_OUT_TOL` for logits; int8 and bf16 cache values
one rounding step apart at most, and at most `FLIP_FRAC` of them: a
sharded sum reorders the float32 bits before the rounding). A trained
state is compared through its change over the two steps (`check_state`),
so an unchanged or zeroed leaf fails. The MoE's own limits
(`MOE_LOSS_RTOL`, `MOE_NORM_RTOL`, `MOE_PARAM_FLIP_FRAC`) come from a
sharded-against-unsharded reading on these 4 ranks: its experts run in
bfloat16, and the float32 sums that the sharded attention reorders
upstream move some bf16 roundings; with the experts in float32 the same
reading gives the dense family's figures (loss within 9e-8, moments
within 7e-7 of their largest). Every rank's local shard shapes equal
what the reference's specs imply (read through `jax.eval_shape` here, in
the parent). MoE routing is bit-equal at a layer's inputs. `jax` is
imported inside the tests only.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ArchBundle, ShapeConfig
from repro_torch.configs.reduced import reduce_config
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed import training as ttr
from repro_torch.distributed.fault_tolerance import TrainLoop
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh_of, make_test_mesh, mesh_shape
from repro_torch.models import transformer as ttf
from repro_torch.serving import engine as teng
from test_torch_mesh import rank_main, spawn

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5  # a gradient leaf, of its largest entry
MOE_GRAD_TOL = 1e-2  # the same where the experts run in bf16
PARAM_FLIP_FRAC = 0.001  # `_assert_params`: params off in all but these
# the MoE's bf16 experts, sharded against unsharded (phi3.5-moe on (2, 2)
# measured a loss 2.3e-5 off, a grad norm 5.0e-4, moments 7.7e-3 of
# their largest, and 2.5% of the param entries off)
MOE_LOSS_RTOL = 1e-4
MOE_NORM_RTOL = 2e-3
MOE_PARAM_FLIP_FRAC = 0.05
MOE_OUT_TOL = 1e-2  # tests/test_torch_moe.py: logits of their largest
MODEL_TOL = 1e-4  # tests/test_torch_lm.py: logits through a whole model
FLIP_FRAC = 0.005  # tests/test_torch_lm.py: cache values one step off
BF16_ULP = 2.0 ** -7  # relative spacing of bfloat16 at its coarsest
F32_ULP = 2.0 ** -23  # the same of float32
SCRIPT = Path(__file__).resolve()
# a group's first steps set up DTensor's sharding propagation for every op
# (about a minute of CPU for a 4-rank group): the join limit of the
# spawned LM groups, above `test_torch_mesh.JOIN_S`'s
LM_JOIN_S = 480.0

TRAIN = ShapeConfig("tiny_train", "train", 32, 8)
PREFILL = ShapeConfig("tiny_prefill", "prefill", 24, 4)
DECODE = ShapeConfig("tiny_decode", "decode", 24, 4)
PROMPT = 20  # prompt tokens; the cache holds 24 rows
# the unshardable-heads model for (data=1, model=3): 2 kv heads do not
# split 3 ways, every weight dim does
THREE_WAY = dict(n_heads=6, n_kv_heads=2, head_dim=24, d_model=48, d_ff=96,
                 vocab_size=96, vocab_pad_multiple=96)


@pytest.fixture
def join_limit(monkeypatch):
    """`spawn` with the LM groups' join limit, for one test."""
    import test_torch_mesh

    monkeypatch.setattr(test_torch_mesh, "JOIN_S", LM_JOIN_S)


# ---------------------------------------------------------------------------
# shared with tests/test_torch_sharding.py (jax-free: the ranks run it)
# ---------------------------------------------------------------------------
def tiny_bundle(arch: str, parallel: dict | None = None,
                **model_kw) -> ArchBundle:
    """The reduced config at 2 layers (3 for the hybrid, so it keeps a
    remainder group), accumulation 2 and logit chunks of 16, as
    `tests/helpers/mini_dryrun.py` sets them."""
    b = get_arch(arch)
    cfg = reduce_config(b.model)
    cfg = cfg.with_(n_layers=3 if cfg.family == "hybrid" else 2,
                    **model_kw)
    return ArchBundle(cfg, b.parallel.with_(grad_accum={"tiny_train": 2},
                                            logit_chunk=16,
                                            **(parallel or {})))


def make_inputs(cfg, abstract: dict, rng, start: int = 0) -> dict:
    """Seeded numpy values for an abstract batch: tokens and labels in the
    vocab, vision rows at the first slots, positions counting from
    `start` (every M-RoPE component the same)."""
    out = {}
    for k, v in abstract.items():
        shape = tuple(v.shape)
        if k in ("tokens", "labels"):
            out[k] = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        elif k == "vision_embeds":
            out[k] = rng.standard_normal(shape).astype(np.float32)
        elif k == "vision_pos":
            out[k] = np.broadcast_to(np.arange(shape[-1], dtype=np.int32),
                                     shape).copy()
        elif k == "positions":
            out[k] = np.broadcast_to(
                np.arange(start, start + shape[-1], dtype=np.int32),
                shape).copy()
    return out


def as_tensors(batch: dict) -> dict:
    return {k: (torch.from_numpy(v).to(torch.bfloat16)
                if k == "vision_embeds" else torch.from_numpy(v))
            for k, v in batch.items()}


def prompt_of(batch: dict) -> dict:
    """A prefill batch cut to its first `PROMPT` positions."""
    out = dict(batch)
    out["tokens"] = out["tokens"][..., :PROMPT]
    if "positions" in out:
        out["positions"] = out["positions"][..., :PROMPT]
    return out


def leaves(tree) -> list:
    return [t for _, t in tsh.tree_items(tree)]


def pairs_of(*trees) -> dict:
    """{path: (leaf of each tree)} of trees with the same leaves, paired
    by path (`sharding.tree_items`), whatever each tree's key order."""
    maps = [dict(tsh.tree_items(t)) for t in trees]
    assert all(m.keys() == maps[0].keys() for m in maps), \
        [sorted(m) for m in maps]
    return {k: tuple(m[k] for m in maps) for k in maps[0]}


def local_shape(shape: tuple, spec, mesh_shape: dict) -> tuple:
    """The per-rank block shape `spec` gives a `shape` tensor on a mesh of
    `mesh_shape` ({axis name: size}): each dim divided by the sizes of the
    axes its entry names."""
    out = list(shape)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        for a in axes:
            out[d] //= mesh_shape[a]
    return tuple(out)


def run_steps(bundle: ArchBundle, mesh, seed: int = 0) -> tuple:
    """Two built train steps, a built prefill and two built decodes, each
    beside the unsharded port's from the same inputs -> ({name: (built,
    plain)} of whole tensors, the built state, the built caches)."""
    rng = np.random.default_rng(seed)
    out = {}
    built = tsteps.build_train_step(bundle, TRAIN, mesh)
    cfg, pcfg = built.cfg, bundle.parallel
    state = ttr.init_train_state(cfg, pcfg,
                                 torch.Generator().manual_seed(seed), "cpu")
    plain = ttr.make_train_step(cfg, pcfg, TRAIN)
    dstate = built.shard(0, state)
    init = state
    for i in range(2):
        batch = as_tensors(make_inputs(cfg, built.abstract_args[1], rng))
        state, m1 = plain(state, batch)
        dstate, m2 = built.fn(dstate, built.shard(1, batch))
        for k in ("loss", "grad_norm"):
            out[f"train{i}/{k}"] = (m2[k], m1[k])
    for path, abc in pairs_of(tsteps.full_tree(dstate), state, init).items():
        out[f"state/{path}"] = abc
    _check_out_placements(dstate, built.out_specs[0], built.mesh)

    bp = tsteps.build_prefill_step(bundle, PREFILL, mesh)
    params = ttf.init_params(bp.cfg, torch.Generator().manual_seed(seed + 1),
                             "cpu")
    pb = as_tensors(prompt_of(make_inputs(cfg, bp.abstract_args[1], rng)))
    o = teng.prefill(params, bp.cfg, pb, cache_len=PREFILL.seq_len,
                     cache_dtype=pcfg.kv_cache_dtype, remat=pcfg.remat)
    dparams = bp.shard(0, params)
    logits, dcache = bp.fn(dparams, bp.shard(1, pb))
    out["prefill/logits"] = (logits, o.logits)
    cache = o.caches
    bd = tsteps.build_decode_step(bundle, DECODE, mesh)
    for i in range(2):
        db = as_tensors(make_inputs(cfg, bd.abstract_args[1], rng,
                                    start=PROMPT + i))
        o = teng.decode_step(params, bd.cfg, db, cache, PROMPT + i)
        cache = o.caches
        logits, dcache = bd.fn(dparams, bd.shard(1, db), dcache,
                               PROMPT + i)
        out[f"decode{i}/logits"] = (logits, o.logits)
    for path, ab in pairs_of(tsteps.full_tree(dcache), cache).items():
        out[f"cache/{path}"] = ab
    _check_out_placements(dcache, bd.out_specs[1], bd.mesh)
    return out, dstate, dcache


def _check_out_placements(tree, specs, mesh) -> None:
    """Every output leaf on the placements of the reference's
    out_shardings."""
    for path, (t, spec) in pairs_of(tree, specs).items():
        assert tuple(t.placements) == tsh.placements(spec, mesh), path


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
CASES = {
    "dense": [("qwen3-8b", {}, {}), ("qwen3-8b-fsdp", {"fsdp": True}, {}),
              ("qwen2-vl-72b", {}, {}), ("musicgen-large", {}, {})],
    "moe": [("phi3.5-moe-42b-a6.6b", {}, {}),
            ("llama4-maverick-400b-a17b", {}, {})],
    "ssm": [("mamba2-1.3b", {}, {}), ("zamba2-1.2b", {}, {})],
    "three": [("qwen2.5-3b", {}, THREE_WAY)],
    "eight": [("qwen2.5-3b", {}, {})],
}
MESH_OF = {"dense": (2, 2), "moe": (2, 2), "ssm": (2, 2), "three": (1, 3),
           "eight": (2, 2, 2)}


def arch_of(name: str) -> str:
    return name.removesuffix("-fsdp")


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def rank_steps(group: str):
    def run(inputs, world):
        mesh = (make_test_mesh(multi_pod=True, device="cpu")
                if MESH_OF[group] == (2, 2, 2)
                else make_mesh_of(MESH_OF[group], "cpu"))
        out = {}
        for name, parallel, model_kw in CASES[group]:
            bundle = tiny_bundle(arch_of(name), parallel, **model_kw)
            pairs, dstate, dcache = run_steps(bundle, mesh,
                                              int(inputs["seed"]))
            for key, (got, want, *init) in pairs.items():
                out[f"{name}|{key}|got"] = _np(got)
                out[f"{name}|{key}|want"] = _np(want)
                if init:
                    out[f"{name}|{key}|init"] = _np(init[0])
            for kind, tree in (("state", dstate), ("cache", dcache)):
                for path, t in tsh.tree_items(tree):
                    out[f"{name}|local|{kind}/{path}"] = np.array(
                        t.to_local().shape)
            if bundle.model.family == "moe":
                out.update({f"{name}|route|{k}": v for k, v in
                            route_check(bundle.model, mesh).items()})
        return out
    return run


def route_check(cfg, mesh) -> dict:
    """The MoE routing of the same grouped inputs, once as plain tensors
    and once as DTensors sharded over the batch as the step places them:
    every field's bits must agree."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import moe

    gen = torch.Generator().manual_seed(7)
    router = torch.randn(cfg.d_model, cfg.n_experts, generator=gen)
    xg = torch.randn(4, 16, cfg.d_model, generator=gen)
    _, cap = moe.capacity(cfg, 16)
    plain = moe.route(router, xg, cfg, cap)
    rules = tsh.ShardingRules()
    with tsh.use_rules(rules), implicit_replication():
        sharded = moe.route(
            tsh.distribute(router, tsh.P(None, None), mesh),
            tsh.distribute(xg, rules.act_spec(("act_batch", None, None)),
                           mesh), cfg, cap)
    return {f: np.array([torch.equal(getattr(plain, f),
                                     tsh.full(getattr(sharded, f)))])
            for f in plain._fields}


def rank_ckpt(inputs, world):
    """Train one step on (2, 2), save, restore onto (1, 4), step again."""
    directory = Path(str(inputs["ckpt"]))
    bundle = tiny_bundle("qwen3-8b")
    rng = np.random.default_rng(0)
    b22 = tsteps.build_train_step(bundle, TRAIN, make_mesh_of((2, 2), "cpu"))
    state = ttr.init_train_state(b22.cfg, bundle.parallel,
                                 torch.Generator().manual_seed(0), "cpu")
    batches = [as_tensors(make_inputs(b22.cfg, b22.abstract_args[1], rng))
               for _ in range(2)]
    dstate, _ = b22.fn(b22.shard(0, state), b22.shard(1, batches[0]))
    ckpt = Checkpointer(directory)
    ckpt.save(1, dstate)
    saved = tsteps.full_tree(dstate)

    b14 = tsteps.build_train_step(bundle, TRAIN, make_mesh_of((1, 4), "cpu"))
    loop = TrainLoop(b14.fn, ckpt)
    restored, step = loop.resume_or_init(lambda: b14.shard(0, state),
                                         b14.shardings(0))
    assert step == 1
    out = {}
    for path, (got, want, spec) in pairs_of(restored, saved,
                                            b14.specs[0]).items():
        assert tuple(got.placements) == tsh.placements(spec, b14.mesh), path
        assert torch.equal(got.full_tensor(), want), path
        out[f"saved/{path}"] = want.numpy()
    new, metrics = b14.fn(restored, b14.shard(1, batches[1]))
    plain_state, plain = ttr.make_train_step(b14.cfg, bundle.parallel,
                                             TRAIN)(saved, batches[1])
    for k in ("loss", "grad_norm"):
        out[f"metric/{k}"] = np.array([float(metrics[k]), float(plain[k])])
    for path, (a, b) in pairs_of(tsteps.full_tree(new),
                                 plain_state).items():
        out[f"step/{path}"] = np.stack([a.numpy().astype(np.float64),
                                        b.numpy().astype(np.float64)])
    out["batch/tokens"] = batches[1]["tokens"].numpy()
    out["batch/labels"] = batches[1]["labels"].numpy()
    return out


# ---------------------------------------------------------------------------
# the parent: tolerances, local shapes against the reference's specs
# ---------------------------------------------------------------------------
def check_group(group: str, outs: list) -> None:
    """Every rank's outputs equal (SPMD); rank 0's within tolerance; each
    rank's local shard shapes as the reference's specs imply."""
    for r, o in enumerate(outs[1:], 1):
        for k, v in outs[0].items():
            if "|local|" not in k:
                assert np.array_equal(v, o[k]), f"rank {r} differs at {k}"
    o = outs[0]
    for name, parallel, model_kw in CASES[group]:
        bundle = tiny_bundle(arch_of(name), parallel, **model_kw)
        moe_family = bundle.model.family == "moe"
        keys = sorted({k.split("|")[1] for k in o
                       if k.startswith(name + "|") and k.endswith("|got")})
        assert keys, name
        state = {}
        for key in keys:
            got = o[f"{name}|{key}|got"]
            want = o[f"{name}|{key}|want"]
            assert got.shape == want.shape and got.dtype == want.dtype, key
            if key.startswith("state"):
                state[key] = (got, want, o[f"{name}|{key}|init"])
            else:
                _close(name, key, got, want, moe_family)
        check_state(name, state, moe_family)
        if moe_family:
            for k, v in o.items():
                if k.startswith(f"{name}|route|"):
                    assert v.all(), f"{name}: routing differs in {k}"
        want = reference_local_shapes(bundle, MESH_OF[group])
        for r, ro in enumerate(outs):
            got = {k.split("|", 2)[2]: tuple(int(x) for x in v)
                   for k, v in ro.items() if k.startswith(f"{name}|local|")}
            assert got == want, f"{name} rank {r}: local shard shapes"


def _close(name, key, got, want, moe_family):
    """A metric, logits or a cache leaf of the built step against the
    unsharded step's."""
    where = f"{name} {key}"
    int8 = want.dtype == np.int8
    got, want = got.astype(np.float64), want.astype(np.float64)
    err = float(np.abs(got - want).max(initial=0.0))
    if key.startswith("train"):
        rtol = LOSS_RTOL if not moe_family else (
            MOE_LOSS_RTOL if key.endswith("loss") else MOE_NORM_RTOL)
        assert err <= rtol * float(np.abs(want).max()), \
            f"{where}: {err} > {rtol} x {want}"
        return
    if not moe_family and key.startswith("cache") and (
            int8 or key.endswith(("/k", "/v"))):
        # an int8 / bf16 cache value a rounding boundary apart: one step
        # (an int8 level, a bf16 ulp), and few of them
        step = 1.0 if int8 else BF16_ULP * np.abs(want)
        off = got != want
        assert (np.abs(got - want) <= step).all(), where
        assert off.mean() <= FLIP_FRAC, f"{where}: {off.mean()} flipped"
        return
    # logits, and float caches and recurrent states written after layers
    # that read a rounded cache: model-level outputs, of their largest
    # (an MoE model's int8 caches too, as tests/test_torch_moe.py holds
    # them)
    tol = MOE_OUT_TOL if moe_family else MODEL_TOL
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    assert err <= tol * scale, f"{where}: {err} > {tol} x {scale}"


def check_state(where: str, leaves: dict, moe_family: bool) -> float:
    """A trained state ({key: (built, unsharded, initial)}) against the
    unsharded step's, through each leaf's change from the initial state,
    so that an unchanged or zeroed leaf fails:

    - a moment (int8 ones as values x their row's scale, with one
      quantization level of the row as slack): its change within
      `GRAD_RTOL` (MoE: `MOE_GRAD_TOL`) of its largest change;
    - a parameter: the same past the two float32 roundings of its value,
      in all but `PARAM_FLIP_FRAC` (MoE: `MOE_PARAM_FLIP_FRAC`) of the
      entries of all parameters: Adam divides a moment by the root of the
      other, so an update whose gradient lies within the summation
      order's noise may turn; any entry within twice its leaf's largest
      update (both steps turned);
    - the step counts exactly.

    Returns the share of parameter entries off."""
    tol = MOE_GRAD_TOL if moe_family else GRAD_RTOL
    flip = MOE_PARAM_FLIP_FRAC if moe_family else PARAM_FLIP_FRAC
    off = n = 0
    for key, arrays in leaves.items():
        if key.endswith("/scales"):
            continue  # read with its values
        got, want, init = (a.astype(np.float64) for a in arrays)
        slack = 0.0
        if key.endswith("/values"):
            scales = leaves[key.removesuffix("values") + "scales"]
            sg, sw, si = (a.astype(np.float64) for a in scales)
            got, want, init = got * sg, want * sw, init * si
            slack = np.maximum(sg, sw)
        dw = want - init
        err = np.abs((got - init) - dw)
        scale = float(np.abs(dw).max(initial=0.0))
        if "/params/" in f"/{key}":
            err = np.maximum(err - 2 * F32_ULP * np.abs(want), 0.0)
            assert (err <= 2 * scale).all(), f"{where} {key}: {err.max()}"
            off += int((err > tol * scale).sum())
            n += err.size
        else:
            assert (err <= tol * scale + slack).all(), (
                f"{where} {key}: change off by {err.max()} of {scale}")
    assert n and off <= flip * n, f"{where}: {off} of {n} params off"
    return off / n


def reference_local_shapes(bundle, mesh_dims) -> dict:
    """{state/... or cache/...: local shape} that the reference's specs
    give the bundle's train state and decode caches on a mesh of
    `mesh_dims`."""
    import jax

    from repro.configs import base as jbase
    from repro.distributed import training as jtr
    from repro.launch import steps as jsteps
    from repro.serving.kv_cache import init_cache as jinit_cache
    from test_torch_sharding import StubMesh, jflat

    mesh = StubMesh(mesh_dims)
    jp = jbase.ParallelConfig(**dataclasses.asdict(bundle.parallel))
    jcfg = jsteps.adapt_model_to_mesh(
        jbase.ModelConfig(**dataclasses.asdict(bundle.model)), mesh)
    hs = jsteps.heads_shardable(jcfg, mesh)
    shp = mesh_shape(mesh)
    out = {}
    rules = jsteps.make_rules(jp, mesh, TRAIN, "train", shard_heads=hs)
    state = jax.eval_shape(lambda: jtr.init_train_state(
        jcfg, jp, jax.random.key(0)))
    shapes = _jshapes(state)
    for path, spec in jflat(jsteps.train_state_specs(state, rules)).items():
        out[f"state/{path}"] = local_shape(shapes[path], spec, shp)
    rules = jsteps.make_rules(jp, mesh, DECODE, "serve", shard_heads=hs)
    cache = jax.eval_shape(lambda: jinit_cache(
        jcfg, DECODE.global_batch, DECODE.seq_len, jp.kv_cache_dtype))
    shapes = _jshapes(cache)
    specs = jsteps._prune(jsteps.cache_partition_specs(jcfg, rules), cache)
    for path, spec in jflat(specs).items():
        out[f"cache/{path}"] = local_shape(shapes[path], spec, shp)
    return out


def _jshapes(tree) -> dict:
    import jax

    from test_torch_sharding import _jkey

    return {"/".join(_jkey(k) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_four_ranks_dense(tmp_path, join_limit):
    outs = spawn(SCRIPT, "dense", 4, {"seed": np.array(0)}, tmp_path)
    check_group("dense", outs)
    # through the unsharded port to the reference's step
    check_reference_chain(outs[0], "qwen3-8b")


def check_reference_chain(out: dict, name: str) -> None:
    """The unsharded port's first step from the seeded state, held against
    the reference's step from the same state carried across."""
    import jax
    import jax.numpy as jnp

    from repro.configs.reduced import reduce_config as jreduce
    from repro.configs.registry import get_arch as jget_arch
    from repro.distributed import training as jtr
    from repro.optim import adamw as jadamw

    bundle = tiny_bundle(name)
    cfg, pcfg = bundle.model, bundle.parallel
    state = ttr.init_train_state(cfg, pcfg, torch.Generator().manual_seed(0),
                                 "cpu")
    jb = jget_arch(name)
    jcfg = jreduce(jb.model).with_(n_layers=cfg.n_layers)
    jp = jb.parallel.with_(grad_accum={"tiny_train": 2}, logit_chunk=16)
    assert pcfg.opt_state_dtype == "float32" and not pcfg.grad_compression
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     state.params)
    jstate = jtr.TrainState(params=jparams,
                            opt=jadamw.init_adamw_state(jparams, "float32"),
                            step=jnp.zeros((), jnp.int32))
    rng = np.random.default_rng(0)
    batch = make_inputs(cfg, tsteps.train_batch_abstract(
        cfg, pcfg, TRAIN, _StubMesh22())[0], rng)
    from repro.configs.base import ShapeConfig as JShape

    _, metrics = jax.jit(jtr.make_train_step(
        jcfg, jp, JShape(TRAIN.name, TRAIN.kind, TRAIN.seq_len,
                         TRAIN.global_batch)))(jstate, batch)
    for k in ("loss", "grad_norm"):
        want = float(metrics[k])
        got = float(out[f"{name}|train0/{k}|want"])
        assert abs(got - want) <= LOSS_RTOL * abs(want), (k, got, want)


class _StubMesh22:
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 2}


if __name__ == "__main__":
    sys.exit(rank_main({**{g: rank_steps(g) for g in CASES},
                        "ckpt": rank_ckpt}))
