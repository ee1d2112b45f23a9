"""The built LM steps on 4 spawned gloo ranks, (data=2, model=2), with
`sharding.FLATTENS_LATER_SHARDS` false: the path the card's torch 2.11
takes, where DTensor's view rule cannot flatten a dim sharded after the
first, so `sharding.matmul` gathers a sequence-sharded input (and the
gradient reaching its output) and `sharding.einsum` runs on each rank's
blocks. This host's torch flattens such dims itself, so without the flag
these helpers are the plain ops.

qwen3-8b (sequence-sharded, attention einsums sharded over batch and
heads) and mamba2-1.3b (the SSD's einsums, the in- and out-projections):
2 train steps, a prefill and 2 decodes each, held to the unsharded port
with the groups and checks of `tests/test_torch_sharding_ranks.py`
(`check_group`)."""
import sys

import numpy as np

import test_torch_sharding_ranks as ranks
from repro_torch.distributed import sharding as tsh
from test_torch_mesh import rank_main, spawn
from test_torch_sharding_ranks import join_limit  # noqa: F401  (a fixture)

SCRIPT = __file__
GROUP = "strict"
ranks.CASES[GROUP] = [("qwen3-8b", {}, {}), ("mamba2-1.3b", {}, {})]
ranks.MESH_OF[GROUP] = (2, 2)


def rank_strict(inputs, world):
    tsh.FLATTENS_LATER_SHARDS = False
    return ranks.rank_steps(GROUP)(inputs, world)


def test_four_ranks_without_strided_flatten(tmp_path, join_limit):
    outs = spawn(SCRIPT, GROUP, 4, {"seed": np.array(0)}, tmp_path)
    ranks.check_group(GROUP, outs)


if __name__ == "__main__":
    sys.exit(rank_main({GROUP: rank_strict}))
