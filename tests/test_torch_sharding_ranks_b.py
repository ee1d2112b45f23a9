"""The built LM steps of the MoE family on 4 spawned gloo ranks, the
unshardable-heads case on 3 and the multi-pod mesh on 8 (the groups and
checks of `tests/test_torch_sharding_ranks.py`, split from it so that
test workers run them side by side).

- 4 ranks, (data=2, model=2): phi3.5-moe and llama4-maverick (its bundle
  sets `moe_shard_ff`), within the MoE's measured limits (`MOE_*` in
  that file), routing bit-equal at a layer's inputs.
- 3 ranks, (data=1, model=3): qwen2.5-3b with 6 heads over 2 kv heads of
  24 (`heads_shardable` False: the prefill sequence-sharded, the cache's
  sequence over `model`).
- 8 ranks, (pod=2, data=2, model=2): qwen2.5-3b.
"""
import numpy as np

from repro_torch.launch import steps as tsteps
from test_torch_mesh import spawn
from test_torch_sharding import StubMesh
from test_torch_sharding_ranks import (
    PREFILL,
    SCRIPT,
    THREE_WAY,
    check_group,
    join_limit,  # noqa: F401  (a fixture)
    tiny_bundle,
)


def test_four_ranks_moe(tmp_path, join_limit):
    outs = spawn(SCRIPT, "moe", 4, {"seed": np.array(0)}, tmp_path)
    check_group("moe", outs)


def test_three_ranks_unshardable_heads(tmp_path, join_limit):
    bundle = tiny_bundle("qwen2.5-3b", **THREE_WAY)
    mesh = StubMesh((1, 3))
    cfg = tsteps.adapt_model_to_mesh(bundle.model, mesh)
    assert not tsteps.heads_shardable(cfg, mesh)
    rules = tsteps.make_rules(bundle.parallel, mesh, PREFILL, "serve",
                              shard_heads=False)
    assert rules.seq_shard and not rules.shard_heads
    outs = spawn(SCRIPT, "three", 3, {"seed": np.array(0)}, tmp_path)
    check_group("three", outs)
    # the cache's sequence lies over `model`: 24 rows, 8 a rank
    assert tuple(outs[1]["qwen2.5-3b|local|cache/k"]) == (2, 4, 2, 8, 24)


def test_eight_ranks_multi_pod(tmp_path, join_limit):
    outs = spawn(SCRIPT, "eight", 8, {"seed": np.array(0)}, tmp_path)
    check_group("eight", outs)
