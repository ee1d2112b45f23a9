"""The built LM steps of the SSM and hybrid families on 4 spawned gloo
ranks, and a sharded train state saved from one mesh and restored onto
others (the port's `shardings` of `Checkpointer.restore_latest` and
`TrainLoop.resume_or_init`); the groups and checks of
`tests/test_torch_sharding_ranks.py`.

- 4 ranks, (data=2, model=2): mamba2-1.3b and zamba2-1.2b.
- Resharding: 4 ranks train reduced qwen3-8b one step on (2, 2), save the
  state (gathered whole, written by rank 0, `fsync`ed as always), and
  restore it through `TrainLoop.resume_or_init` onto (1, 4): every leaf
  bit-equal as a whole tensor and placed as the (1, 4) step takes it;
  then one step there, against the unsharded step from the same state.
  This process restores the same checkpoint onto (1, 1) (a one-rank gloo
  group) and takes a step there that equals the unsharded one bit for
  bit.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.distributed import training as ttr
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh_of
from test_torch_mesh import init_group, spawn
from test_torch_sharding_ranks import (
    LOSS_RTOL,
    SCRIPT,
    TRAIN,
    check_group,
    check_state,
    join_limit,  # noqa: F401  (a fixture)
    pairs_of,
    tiny_bundle,
)


def test_four_ranks_ssm_hybrid(tmp_path, join_limit):
    outs = spawn(SCRIPT, "ssm", 4, {"seed": np.array(0)}, tmp_path)
    check_group("ssm", outs)


@pytest.fixture
def world1(tmp_path_factory):
    init_group(0, 1, tmp_path_factory.mktemp("rendezvous"))
    yield
    dist.destroy_process_group()


def test_checkpoint_reshards_on_restore(tmp_path, world1, join_limit):
    directory = tmp_path / "ckpt"
    ranks = tmp_path / "ranks"
    ranks.mkdir()
    outs = spawn(SCRIPT, "ckpt", 4, {"ckpt": np.array(str(directory))},
                 ranks)
    out = outs[0]
    for k in ("loss", "grad_norm"):
        got, want = out[f"metric/{k}"]
        assert abs(got - want) <= LOSS_RTOL * abs(want), k
    check_state("(1, 4) step", {
        k: (v[0], v[1], out["saved/" + k.removeprefix("step/")])
        for k, v in out.items() if k.startswith("step/")}, False)

    # the same checkpoint onto a (1, 1) mesh in this process
    bundle = tiny_bundle("qwen3-8b")
    b11 = tsteps.build_train_step(bundle, TRAIN, make_mesh_of((1, 1), "cpu"))
    template = ttr.init_train_state(b11.cfg, bundle.parallel,
                                    torch.Generator().manual_seed(1), "cpu")
    step, restored = Checkpointer(directory).restore_latest(
        b11.shard(0, template), b11.shardings(0))
    assert step == 1
    for path, (got,) in pairs_of(restored).items():
        assert np.array_equal(got.full_tensor().numpy(),
                              out[f"saved/{path}"]), path
    batch = {"tokens": torch.from_numpy(out["batch/tokens"]),
             "labels": torch.from_numpy(out["batch/labels"])}
    new, metrics = b11.fn(restored, b11.shard(1, batch))
    saved = tsteps.full_tree(restored)
    plain_state, plain = ttr.make_train_step(b11.cfg, bundle.parallel,
                                             TRAIN)(saved, batch)
    for k in ("loss", "grad_norm"):
        assert torch.equal(metrics[k], plain[k]), k
    for path, (a, b) in pairs_of(tsteps.full_tree(new),
                                 plain_state).items():
        assert torch.equal(a, b), path
