"""The port's op-count analysis (`repro_torch/launch/hlo_analysis.py`)
against hand counts, as `tests/test_hlo_analysis.py` holds the
reference's HLO analyzer, and against the reference's `analyze_hlo` on
the same functions.

The port has no HLO: `OpRecorder` records the ops a real run dispatches,
`FakeOpRecorder` those reaching its fake tensors, and `analyze_ops` sums
the records. The collective counts run on an 8-rank `fake` process group
in a subprocess (the group is process-wide)."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.launch.hlo_analysis import (
    FakeOpRecorder,
    OpRecord,
    OpRecorder,
    analyze_ops,
)

ROOT = Path(__file__).resolve().parents[1]


def recorded(fn, *args) -> list:
    with OpRecorder() as rec:
        fn(*args)
    return rec.records


def _ref_flops(fn, *shapes) -> float:
    structs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo(jax.jit(fn).lower(*structs).compile().as_text()).flops


def _repeat(n):
    def f(x, w):
        for _ in range(n):
            x = x @ w
        return x
    return f


def test_single_matmul_flops():
    x, w = torch.ones(128, 256), torch.ones(256, 64)
    stats = analyze_ops(recorded(lambda a, b: a @ b, x, w))
    assert stats.flops == 2 * 128 * 256 * 64
    assert stats.flops == _ref_flops(lambda a, b: a @ b, (128, 256),
                                     (256, 64))


def test_repeated_matmuls_count_every_repeat():
    """Eager code runs every repeat, so the count needs no trip count:
    10 repeats are 10 matmuls, as the reference's corrected scan."""
    x, w = torch.ones(128, 128), torch.ones(128, 128)
    stats = analyze_ops(recorded(_repeat(10), x, w))
    one = 2 * 128 * 128 * 128
    assert stats.flops == 10 * one

    def scanned(a, b):
        y, _ = jax.lax.scan(lambda c, _: (c @ b, None), a, None, length=10)
        return y

    assert stats.flops == _ref_flops(scanned, (128, 128), (128, 128))


def test_nested_loops_count_twelve():
    x, w = torch.ones(64, 64), torch.ones(64, 64)

    def f(a, b):
        for _ in range(3):
            for _ in range(4):
                a = a @ b
        return a

    assert analyze_ops(recorded(f, x, w)).flops == 12 * 2 * 64 ** 3


def test_hbm_bytes_scale_with_repeats():
    x, w = torch.ones(256, 256), torch.ones(256, 256)
    s1 = analyze_ops(recorded(_repeat(1), x, w))
    s10 = analyze_ops(recorded(_repeat(10), x, w))
    assert s1.hbm_bytes == 3 * 256 * 256 * 4  # two inputs and the output
    assert s10.hbm_bytes > 5 * s1.hbm_bytes


def test_hand_made_records():
    """Views 0; pointwise ops their outputs (`hbm_bytes`) or inputs and
    outputs (`hbm_bytes_eager`); other ops both; collectives' operands
    from their results and groups, the reference's way."""
    f32 = "float32"
    recs = [
        OpRecord("aten.view.default", "view", (((4, 8), f32),),
                 (((32,), f32),)),
        OpRecord("aten.add.Tensor", "pointwise",
                 (((4, 8), f32), ((4, 8), "bfloat16")), (((4, 8), f32),)),
        OpRecord("aten.mm.default", "op", (((4, 8), f32), ((8, 2), f32)),
                 (((4, 2), f32),), flops=2 * 4 * 8 * 2),
        OpRecord("_c10d_functional.all_gather_into_tensor.default",
                 "all-gather", (((1, 16), f32),), (((8, 16), f32),),
                 group=8),
        OpRecord("_c10d_functional.reduce_scatter_tensor.default",
                 "reduce-scatter", (((8, 16), "bfloat16"),),
                 (((1, 16), "bfloat16"),), group=8),
        OpRecord("_c10d_functional.all_reduce.default", "all-reduce",
                 (((3, 5), "int32"),), (((3, 5), "int32"),), group=4),
    ]
    st = analyze_ops(recs, total_devices=16)
    assert st.flops == 128
    assert st.per_collective == {"all-gather": 64, "reduce-scatter": 256,
                                 "all-reduce": 60}
    assert st.collective_bytes == 380 and st.collective_count == 3
    add, mm = 4 * 8 * 4, (32 + 16 + 8) * 4
    coll = (64 + 512) + (256 + 32) + (60 + 60)
    assert st.hbm_bytes == add + mm + coll
    assert st.hbm_bytes_eager == (add + 64 + add) + mm + coll
    # a group left unrecorded counts every device, as the reference's
    gathered = OpRecord("_c10d_functional.all_gather_into_tensor.default",
                        "all-gather", (((1, 16), f32),), (((16, 16), f32),))
    assert analyze_ops([gathered], total_devices=16).collective_bytes == 64
    assert [OpRecord.from_json(json.loads(json.dumps(r.to_json())))
            for r in recs] == recs


def test_fake_recorder_counts_fake_tensors_once():
    """A fake matmul counts as a real one; each op the tensors reach is
    one record (the ops the fake mode runs inside it are not recorded);
    a real tensor over the limit is refused."""
    with FakeOpRecorder(max_real_bytes=1 << 10) as fake:
        x, w = torch.empty(128, 256), torch.empty(256, 64)
        fake.records.clear()
        torch.nn.functional.linear(x, w.t())
        x.softmax(-1)
    ops = [r.op for r in fake.records if not r.op.startswith("prim.")]
    assert analyze_ops(fake.records).flops == 2 * 128 * 256 * 64
    assert ops == ["aten.t.default", "aten.t.default", "aten.mm.default",
                   "aten._softmax.default"], ops
    real = torch.ones(64, 64)
    with pytest.raises(RuntimeError, match="real tensor"):
        with FakeOpRecorder(max_real_bytes=1 << 10):
            real @ torch.empty(64, 64)


COLLECTIVES = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.hlo_analysis import FakeOpRecorder, analyze_ops
    from repro_torch.launch.mesh import make_mesh_of
    from repro_torch.utils import make_mesh

    fake_group(8)
    mesh = make_mesh((8,), ("model",), "cpu")
    group = mesh.get_group("model")
    out = {}
    fake = FakeOpRecorder()
    with fake:
        shard = torch.empty(1, 1024)
        whole = torch.empty(8, 1024)
    for name, fn in (
            ("all_reduce", lambda: funcol.all_reduce(shard, "sum", group)),
            ("all_gather", lambda: funcol.all_gather_tensor(shard, 0, group)),
            ("reduce_scatter",
             lambda: funcol.reduce_scatter_tensor(whole, "sum", 0, group)),
            # the dry run's way: DTensor outside the mode, fake locals
            ("dtensor_psum", lambda: DTensor.from_local(
                shard, mesh, [Partial()]).redistribute(
                    mesh, [Replicate()]).to_local()),
            ("dtensor_gather", lambda: DTensor.from_local(
                shard, mesh, [Shard(0)]).full_tensor())):
        fake.records.clear()
        fn()
        st = analyze_ops(fake.records, 8)
        out[name] = [st.collective_bytes, st.per_collective,
                     st.collective_count,
                     [r.group for r in fake.records if r.group]]
    assert "jax" not in sys.modules
    print(json.dumps(out))
""")


def test_collective_bytes_with_groups():
    """On an 8-rank fake group: an all-reduce of a (1, 1024) float32
    shard is 4,096 operand bytes under `all-reduce`; an all-gather's
    operand is its result / 8, a reduce-scatter's its result x 8."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", COLLECTIVES],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["all_reduce"] == [4096, {"all-reduce": 4096}, 1, [8]]
    assert got["all_gather"] == [4096, {"all-gather": 4096}, 1, [8]]
    assert got["reduce_scatter"] == [32768, {"reduce-scatter": 32768}, 1,
                                     [8]]
    assert got["dtensor_psum"] == got["all_reduce"]
    assert got["dtensor_gather"] == got["all_gather"]
