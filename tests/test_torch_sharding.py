"""The port's sharded LM plan against the JAX reference's, on the CPU.

Rules and specs, leaf for leaf: the reference's `make_rules`,
`adapt_model_to_mesh`, `heads_shardable` and the spec builders read only
`mesh.shape` and `mesh.axis_names`, so one stub mesh object serves both
packages (no devices). For each of the 10 arch ids, each of the 4 `SHAPES`
and the meshes 16x16, 2x16x16, 2x4, 2x2x2 and 1x3: `kv_repeat`, every
`ShardingRules` field, the parameter specs over the full-size tree (the
port's on `meta`, the reference's from `jax.eval_shape`) with `fsdp` on and
off and with `moe_ff_fsdp`, the train-state specs (int8 `QuantState`
scales and the compression error buffer included), the pruned cache specs
and the batch specs (or the same divisibility assert).

The built steps at world size 1, in this process (a one-rank gloo group,
`file://` rendezvous in a temporary directory), on (1, 1) and (1, 1, 1)
meshes: for each of the 10 ids, `build_train_step` (2 steps, accumulation
2, `logit_chunk=16`), `build_prefill_step` and 2 `build_decode_step`s give
the unsharded port's (`make_train_step`, `prefill`, `decode_step`) bits.
The spawned groups of 3, 4 and 8 ranks are in
`tests/test_torch_sharding_ranks.py`.
"""
import dataclasses
import functools
import sys

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs.registry import get_arch as jget_arch
from repro.distributed import sharding as jsh
from repro.distributed import training as jtr
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.serving.kv_cache import init_cache as jinit_cache
from repro_torch.configs.base import SHAPES
from repro_torch.configs.reduced import reduce_config
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed import training as ttr
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh_of
from repro_torch.models import transformer as ttf
from repro_torch.serving.kv_cache import init_cache
from repro_torch.utils import tree_leaves
from test_torch_mesh import init_group
from test_torch_sharding_ranks import (
    TRAIN,
    leaves,
    local_shape,
    run_steps,
    tiny_bundle,
)

MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16), "2x4": (2, 4),
          "2x2x2": (2, 2, 2), "1x3": (1, 3)}


class StubMesh:
    """What the spec builders of both packages read of a mesh."""

    def __init__(self, shape):
        self.axis_names = (("data", "model") if len(shape) == 2
                           else ("pod", "data", "model"))
        self.shape = dict(zip(self.axis_names, shape))


# ---------------------------------------------------------------------------
# spec trees as {path: entries}
# ---------------------------------------------------------------------------
def _jkey(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def jflat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(_jkey(k) for k in path): tuple(leaf)
            for path, leaf in leaves}


def tflat(tree, path=()) -> dict:
    if isinstance(tree, tsh.PartitionSpec):
        return {"/".join(path): tuple(tree)}
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(tflat(v, path + (str(k),)))
    return out


@functools.lru_cache(maxsize=None)
def _abstract(arch: str, opt_dtype: str, compression: bool):
    """(reference abstract train state, port meta train state) at full
    size."""
    jb, tb = jget_arch(arch), get_arch(arch)
    jp = jb.parallel.with_(opt_state_dtype=opt_dtype,
                           grad_compression=compression)
    tp = tb.parallel.with_(opt_state_dtype=opt_dtype,
                           grad_compression=compression)
    jstate = jax.eval_shape(
        lambda: jtr.init_train_state(jb.model, jp, jax.random.key(0)))
    tstate = ttr.init_train_state(tb.model, tp, None, device="meta")
    return jstate, tstate


def _outcome(fn, *args):
    """fn's result, or the type of the assertion it raised."""
    try:
        return fn(*args)
    except AssertionError:
        return AssertionError


def test_partition_spec_normalizes_like_jax():
    for entries in [(), (None,), ("model", ("data",)), (("pod", "data"),),
                    (None, ("pod", "data"), None), ("model", None)]:
        assert tuple(tsh.P(*entries)) == tuple(JP(*entries)), entries


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch, mesh_name):
    mesh = StubMesh(MESHES[mesh_name])
    jb, tb = jget_arch(arch), get_arch(arch)
    jcfg = jsteps.adapt_model_to_mesh(jb.model, mesh)
    tcfg = tsteps.adapt_model_to_mesh(tb.model, mesh)
    assert tcfg.kv_repeat == jcfg.kv_repeat
    hs = tsteps.heads_shardable(tcfg, mesh)
    assert hs == jsteps.heads_shardable(jcfg, mesh)
    jstate, tstate = _abstract(arch, jb.parallel.opt_state_dtype,
                               jb.parallel.grad_compression)
    for shape_name, tshape in SHAPES.items():
        jshape = jsteps.SHAPES[shape_name]
        kind = "train" if tshape.kind == "train" else "serve"
        jrules = jsteps.make_rules(jb.parallel, mesh, jshape, kind,
                                   shard_heads=hs)
        trules = tsteps.make_rules(tb.parallel, mesh, tshape, kind,
                                   shard_heads=hs)
        assert dataclasses.asdict(trules) == dataclasses.asdict(jrules)
        where = f"{arch} {shape_name} {mesh_name}"
        for change in ({}, {"fsdp": not trules.fsdp}, {"moe_ff_fsdp": True}):
            jr = dataclasses.replace(jrules, **change)
            tr_ = dataclasses.replace(trules, **change)
            assert tflat(tsh.param_partition_specs(tstate.params, tr_)) == \
                jflat(jsh.param_partition_specs(jstate.params, jr)), where
        assert tflat(tsteps.train_state_specs(tstate, trules)) == \
            jflat(jsteps.train_state_specs(jstate, jrules)), where
        if kind == "train":
            jout = _outcome(jsteps.train_batch_abstract, jcfg, jb.parallel,
                            jshape, mesh)
            tout = _outcome(tsteps.train_batch_abstract, tcfg, tb.parallel,
                            tshape, mesh)
        else:
            jout = jsteps.serve_batch_abstract(jcfg, jshape, mesh, jrules,
                                               tshape.kind)
            tout = tsteps.serve_batch_abstract(tcfg, tshape, mesh, trules,
                                               tshape.kind)
            jcache = jax.eval_shape(lambda: jinit_cache(
                jcfg, jshape.global_batch, jshape.seq_len,
                jb.parallel.kv_cache_dtype))
            tcache = init_cache(tcfg, tshape.global_batch, tshape.seq_len,
                                tb.parallel.kv_cache_dtype, device="meta")
            assert tflat(tsteps._prune(
                tsteps.cache_partition_specs(tcfg, trules), tcache)) == \
                jflat(jsteps._prune(jsteps.cache_partition_specs(
                    jcfg, jrules), jcache)), where
            # the abstract caches themselves: shapes and dtypes
            assert [tuple(t.shape) for t in tree_leaves(tcache)] == \
                [tuple(a.shape) for a in jax.tree_util.tree_leaves(jcache)]
        if jout is AssertionError or tout is AssertionError:
            assert tout is jout, where
            continue
        (jbatch, jspecs), (tbatch, tspecs) = jout, tout
        assert tflat(tspecs) == jflat(jspecs), where
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tbatch.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in jbatch.items()}


@pytest.mark.parametrize("arch", ["llama3-405b", "qwen3-8b",
                                  "phi3.5-moe-42b-a6.6b", "zamba2-1.2b"])
def test_train_state_specs_int8_and_compression(arch):
    """int8 moments (`QuantState` scales on spec[:-1] + (None,)) and the
    error buffer, on the production meshes."""
    jstate, tstate = _abstract(arch, "int8", True)
    for shape in ((16, 16), (2, 16, 16)):
        mesh = StubMesh(shape)
        for fsdp in (False, True):
            jr = jsh.ShardingRules(data_axes=jsteps.data_axes_of(mesh),
                                   fsdp=fsdp)
            tr_ = tsh.ShardingRules(data_axes=tsteps.data_axes_of(mesh),
                                    fsdp=fsdp)
            got = tflat(tsteps.train_state_specs(tstate, tr_))
            assert got == jflat(jsteps.train_state_specs(jstate, jr))
            assert any(k.endswith("scales") for k in got)
            assert any(k.startswith("err_buf") for k in got)


def test_abstract_params_match_reference_shapes():
    """`init_params(..., device="meta")`: every leaf's shape and dtype,
    no storage, at full size."""
    for arch in ARCH_IDS:
        jp = jax.eval_shape(lambda: jtf.init_params(jget_arch(arch).model,
                                                    jax.random.key(0)))
        tp = tsteps.params_abstract(get_arch(arch).model)
        assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
                for t in tree_leaves(tp)] == \
            [(tuple(a.shape), str(a.dtype))
             for a in jax.tree_util.tree_leaves(jp)], arch
        assert all(t.is_meta for t in tree_leaves(tp))


def test_meta_is_refused_by_the_entry_points():
    from repro_torch.utils import resolve_device

    with pytest.raises(ValueError, match="meta"):
        resolve_device("meta")


# ---------------------------------------------------------------------------
# the four rule tests of tests/test_distribution.py, on the port
# ---------------------------------------------------------------------------
def test_param_specs_follow_rules():
    cfg = reduce_config(get_arch("qwen3-8b").model)
    params = tsteps.params_abstract(cfg)
    specs = tsh.param_partition_specs(
        params, tsh.ShardingRules(data_axes=("data",), fsdp=True))
    assert specs["embed"] == tsh.P("model", ("data",))
    assert specs["layers"]["attn"]["wq"]["w"] == tsh.P(None, ("data",),
                                                       "model")
    assert specs["final_norm"] == tsh.P(None)
    specs2 = tsh.param_partition_specs(
        params, tsh.ShardingRules(data_axes=("data",), fsdp=False))
    assert specs2["embed"] == tsh.P("model", None)


def test_moe_param_specs():
    cfg = reduce_config(get_arch("phi3.5-moe-42b-a6.6b").model)
    params = tsteps.params_abstract(cfg)
    specs = tsh.param_partition_specs(
        params, tsh.ShardingRules(data_axes=("pod", "data"), fsdp=True))
    assert specs["layers"]["moe"]["wi"] == tsh.P(None, "model",
                                                 ("pod", "data"), None)


def test_constrain_noop_without_rules():
    x = torch.ones((4, 4))
    assert tsh.constrain(x, ("act_batch", None)) is x


def test_unshardable_heads_rules():
    assert tsh.ShardingRules(shard_heads=False).act_axis("act_heads") is None
    assert tsh.ShardingRules(shard_heads=True).act_axis("act_heads") == \
        "model"


def test_use_rules_sets_and_resets():
    rules = tsh.ShardingRules(seq_shard=True)
    assert tsh.active_rules() is None
    with tsh.use_rules(rules):
        assert tsh.active_rules() is rules
    assert tsh.active_rules() is None


def test_local_shape_follows_the_spec():
    mesh = {"pod": 2, "data": 16, "model": 16}
    assert local_shape((256, 4096, 128), tsh.P(("pod", "data"), None,
                                               "model"), mesh) == (8, 4096, 8)


def test_port_modules_import_no_jax():
    """The new and changed modules import neither jax nor repro."""
    import subprocess

    code = ("import sys; import repro_torch.launch.steps, "
            "repro_torch.launch.mesh, repro_torch.distributed.sharding, "
            "repro_torch.checkpoint.checkpointer, "
            "repro_torch.distributed.fault_tolerance; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# the built steps at world size 1, in this process
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    init_group(0, 1, tmp_path_factory.mktemp("rendezvous"))
    yield
    dist.destroy_process_group()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_built_steps_world1_bit_equal(world1, arch):
    """Every arch's built train, prefill and decode steps on a (1, 1)
    mesh give the unsharded port's bits (one-rank mesh dims place
    nothing, so every op runs on the whole tensor)."""
    mesh = make_mesh_of((1, 1), "cpu")
    for name, (got, want, *_) in run_steps(tiny_bundle(arch), mesh)[0].items():
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.equal(got, want), f"{arch} {name}"


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-1.2b"])
def test_built_steps_world1_multi_pod_bit_equal(world1, arch):
    """A (1, 1, 1) mesh: the (pod, data) axes run as one flattened mesh
    dim."""
    mesh = make_mesh_of((1, 1, 1), "cpu")
    built = tsteps.build_train_step(tiny_bundle(arch), TRAIN, mesh)
    assert tuple(built.mesh.mesh_dim_names) == ("pod_data", "model")
    assert built.rules.data_axes == ("pod", "data")
    for name, (got, want, *_) in run_steps(tiny_bundle(arch), mesh)[0].items():
        assert torch.equal(got, want), f"{arch} {name}"


def test_mesh_refuses_a_wrong_world_size(world1):
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh_of((2, 2), "cpu")


class StubDeviceMesh:
    """A (data=1, model=2) `DeviceMesh` as `placements` reads one."""

    mesh_dim_names = ("data", "model")
    shape = (1, 2)


def test_indivisible_placement_names_arch_and_leaf():
    """JAX's shardings refuse a dim the mesh does not divide; so does the
    port (DTensor would shard it unevenly), naming the arch and leaf."""
    cfg = tiny_bundle("qwen3-8b").model.with_(vocab_size=101,
                                              vocab_pad_multiple=101)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = tsh.param_partition_specs(params, tsh.ShardingRules())
    with pytest.raises(ValueError, match=r"qwen3-8b: embed: dim 0 of "
                                         r"\(101, 64\) is not divisible"):
        tsh.shard_tree(params, specs, StubDeviceMesh(), what="qwen3-8b: ")


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_by_slabs_is_bit_equal(state_dtype, monkeypatch):
    """AdamW over a large leaf's leading-dim slabs (the float32
    temporaries of one slab at a time) gives the whole update's bits,
    two steps running, int8 moments' scales included."""
    from repro_torch.optim import adamw

    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(300, 70, generator=gen).to(torch.bfloat16),
              "b": torch.randn(5, 40, 30, generator=gen),
              "c": torch.randn(7, generator=gen)}
    grads = [{k: torch.randn(v.shape, generator=gen) for k, v in
              params.items()} for _ in range(2)]

    def two_steps():
        p, st = params, adamw.init_adamw_state(params, state_dtype)
        for g in grads:
            p, st = adamw.adamw_update(g, st, p, 1e-3,
                                       state_dtype=state_dtype)
        return leaves(p) + leaves([st.mu, st.nu, st.count])

    whole = two_steps()
    monkeypatch.setattr(adamw, "_SLAB_ELEMS", 1000)  # 14 and 2 slabs
    slabbed = two_steps()
    assert all(torch.equal(a, b) for a, b in zip(whole, slabbed))
