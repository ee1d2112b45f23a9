"""The regions of the sharded LM plan that run on each rank's blocks,
each alone, as rank 0 of an 8-rank `fake` group on the (2, 4) test mesh
(data=2, model=4), the way the dry run (`repro_torch/launch/dryrun.py`)
runs a cell: fake inputs placed by their specs, the region's forward and
backward run outside the fake mode, its tensor-less calls sent into it,
its live tensor bytes counted by `_LiveBytes`.

Each region's peak live bytes less its inputs' (its temporaries) are held
to a bound computed here from the rank's local block shapes: a few of
the region's own blocks, never a tensor of a global shape. Beside each
bound stands what the plan before these regions ran on blocks made of
the same region (this file's regions run on that code): the
cross-entropy, the attention's forward and the embedding broke their
bounds by 4-6.4x, more than the model axis's 4; the audio embedding and
the mamba2 block by 1.8x and 3.1x, where the rank's own irreducible
blocks (the table gradient, the SSD's chunk matrices) fill the bound;
the attention's backward not at all (its fault was the forward's).

- the chunked cross-entropy, forward and backward (`_BlockNLL` on each
  rank's vocabulary block);
- the blocked attention's forward and its custom backward (the running
  state made like `q`);
- the token embedding's gather and its backward, plain and audio (a
  masked gather of the rank's row block, the rank's segments summed);
- the mamba2 block, forward and backward (the in-projection's parts
  each sharded along its own columns, the SSD on the rank's heads).

Values are held elsewhere: the spawned gloo groups of
`tests/test_torch_sharding_ranks.py` (and `_b`, `_c`) run these regions
on 3, 4 and 8 ranks against the unsharded port. The fake group is
process-wide, so the regions run in one subprocess (this file's
`__main__`), which writes each region's counts.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = Path(__file__).resolve()
MESH = (2, 4)  # (data, model)
DATA, MODEL = MESH
JOIN_S = 240.0
F32 = 4

# the region shapes (global); each rank holds 1/2 of the batch and 1/4 of
# the vocabulary, heads or columns
B, S = 8, 64
VOCAB, D = 16384, 64  # the embedding's table
CE_VOCAB, CE_D, CHUNK = 8192, 16, 32  # the cross-entropy's head, chunk
HEADS, HD, BLOCK_K = 8, 64, 8  # attention: (B, R = 8, G = 1, S, hd)
BOOKS = 2  # the audio model's codebooks
SSM_S, SSM_Q = 256, 64  # the mamba2 block's sequence and SSD chunk


def _mb(n: int) -> str:
    return f"{n / 2**20:.2f} MiB"


# ---------------------------------------------------------------------------
# the regions (run in the subprocess)
# ---------------------------------------------------------------------------
def _setup():
    import torch

    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.hlo_analysis import FakeOpRecorder
    from repro_torch.launch.mesh import make_mesh_of

    torch.manual_seed(0)
    fake_group(DATA * MODEL)
    return make_mesh_of(MESH, "cpu"), FakeOpRecorder(), ShardingRules()


def _peak(fake, rules, inputs: list, fn, before=None) -> int:
    """The temporaries' peak (live bytes less the inputs') of `fn()`,
    run as the dry run runs a step; after `before()`, the peak of `fn()`
    less what `before()` left live."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import is_dtensor, use_rules
    from repro_torch.launch.dryrun import _FakeFactories, _LiveBytes

    locals_ = [t.to_local() if is_dtensor(t) else t for t in inputs]
    live = _LiveBytes(fake, locals_)
    base = live.now
    with live, _FakeFactories(fake), use_rules(rules), \
            implicit_replication():
        if before is not None:
            before()
            base = live.peak = live.now
        fn()
    return live.peak - base


def _place(fake, mesh, shape, spec, dtype=None, grad=False):
    import torch

    from repro_torch.distributed.sharding import P, distribute

    with fake:
        t = torch.empty(shape, dtype=dtype or torch.float32)
    t = distribute(t, P(*spec), mesh)
    return t.requires_grad_(True) if grad else t


def _ids(fake, mesh, shape, spec):
    import torch

    return _place(fake, mesh, shape, spec, torch.long)


def region_cross_entropy(mesh, fake, rules) -> dict:
    import torch

    from repro_torch.configs.reduced import reduce_config
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.training import chunked_cross_entropy

    cfg = reduce_config(get_arch("qwen3-8b").model).with_(
        d_model=CE_D, vocab_size=CE_VOCAB, vocab_pad_multiple=CE_VOCAB)
    hidden = _place(fake, mesh, (B, S, CE_D), ("data", None, None),
                    grad=True)
    head = _place(fake, mesh, (CE_D, CE_VOCAB), (None, "model"), grad=True)
    labels = _ids(fake, mesh, (B, S), ("data", None))

    def run():
        loss = chunked_cross_entropy({"lm_head": head}, cfg, hidden, labels,
                                     CHUNK)
        torch.autograd.grad(loss, [hidden, head])

    return {"peak": _peak(fake, rules, [hidden, head, labels], run)}


def _attention_inputs(mesh, fake, grad: bool):
    q = _place(fake, mesh, (B, HEADS, 1, S, HD),
               ("data", "model", None, None, None), grad=grad)
    k, v = (_place(fake, mesh, (B, HEADS, S, HD),
                   ("data", "model", None, None), grad=grad)
            for _ in range(2))
    return q, k, v


def region_attention_forward(mesh, fake, rules) -> dict:
    import torch

    from repro_torch.models.attention import gqa_blocked_attention

    q, k, v = _attention_inputs(mesh, fake, grad=False)

    def run():
        with torch.no_grad():  # as a prefill runs it: `_blocked_forward`
            gqa_blocked_attention(q, k, v, causal=True, block_k=BLOCK_K)

    return {"peak": _peak(fake, rules, [q, k, v], run)}


def region_attention_backward(mesh, fake, rules) -> dict:
    """The custom backward alone: its peak less what the forward left."""
    import torch

    from repro_torch.models.attention import gqa_blocked_attention

    q, k, v = _attention_inputs(mesh, fake, grad=True)
    state = {}

    def forward():
        state["out"] = gqa_blocked_attention(q, k, v, causal=True,
                                             block_k=BLOCK_K)

    def backward():
        out = state.pop("out")
        torch.autograd.grad(out, [q, k, v], torch.ones_like(out))

    return {"peak": _peak(fake, rules, [q, k, v], backward, before=forward)}


def _embed_region(mesh, fake, rules, audio: bool) -> dict:
    import torch

    from repro_torch.configs.reduced import reduce_config
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import embed_tokens

    arch = "musicgen-large" if audio else "qwen3-8b"
    cfg = reduce_config(get_arch(arch).model).with_(d_model=D)
    books = (BOOKS,) if audio else ()
    table = _place(fake, mesh, books + (VOCAB, D),
                   (None,) * len(books) + ("model", None), grad=True)
    tokens = _ids(fake, mesh, (B,) + books + (S,),
                  ("data",) + (None,) * (len(books) + 1))

    def run():
        x = embed_tokens({"embed": table}, cfg, {"tokens": tokens})
        torch.autograd.grad(x, [table], torch.ones_like(x))

    return {"peak": _peak(fake, rules, [table, tokens], run)}


def region_embedding(mesh, fake, rules) -> dict:
    return _embed_region(mesh, fake, rules, audio=False)


def region_embedding_audio(mesh, fake, rules) -> dict:
    return _embed_region(mesh, fake, rules, audio=True)


def region_mamba2(mesh, fake, rules) -> dict:
    import torch

    from repro_torch.configs.reduced import reduce_config
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.sharding import (
        param_partition_specs,
        shard_tree,
    )
    from repro_torch.models import ssm

    cfg = reduce_config(get_arch("mamba2-1.3b").model).with_(
        ssm_chunk=SSM_Q)
    with fake:
        p = ssm.init_mamba2(None, cfg, "meta")
        p = {k: torch.empty(v.shape, dtype=v.dtype) for k, v in p.items()}
    p = shard_tree({"ssm": p}, param_partition_specs({"ssm": p}, rules),
                   mesh)["ssm"]
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    x = _place(fake, mesh, (B, SSM_S, cfg.d_model), ("data", None, None),
               grad=True)

    def run():
        y, _ = ssm.mamba2_block(p, x, cfg)
        torch.autograd.grad(y, [x, *p.values()], torch.ones_like(y))

    return {"peak": _peak(fake, rules, [x, *p.values()], run),
            "cfg": [cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state,
                    cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                    cfg.ssm_chunk, cfg.d_model]}


REGIONS = {
    "cross_entropy": region_cross_entropy,
    "attention_forward": region_attention_forward,
    "attention_backward": region_attention_backward,
    "embedding": region_embedding,
    "embedding_audio": region_embedding_audio,
    "mamba2": region_mamba2,
}


def main(out: Path) -> None:
    mesh, fake, rules = _setup()
    res = {name: fn(mesh, fake, rules) for name, fn in REGIONS.items()}
    assert "jax" not in sys.modules and "repro" not in sys.modules
    out.write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# the bounds: from the rank's local blocks
# ---------------------------------------------------------------------------
b = B // DATA  # the rank's sequences


def bound_cross_entropy(_) -> int:
    """The rank's float32 logits block of one chunk, (b, chunk, V / model),
    4 times: the logits, their exponentials, the backward's gradient and
    the head's and hidden state's gradient blocks. The plan before
    peaked at 20.15 MiB, 5.0x this bound: the chunk's logits gathered over
    the vocabulary and its backward's buffer of the global (B, chunk, V)
    shape."""
    return 4 * b * CHUNK * (CE_VOCAB // MODEL) * F32


def _attention_block() -> int:
    return b * (HEADS // MODEL) * S * HD * F32  # (b, R / model, 1, S, hd)


def bound_attention_forward(_) -> int:
    """The rank's float32 (b, R / model, 1, S, hd) block 3 times (q
    scaled, the accumulator, a kv block's product or the output), a kv
    block's scores and probabilities twice each, and the running max and
    sum. The plan before peaked at 1.79 MiB, 4.06x this bound: its
    running state had the global (B, R, G, S) and (B, R, G, S, hd)
    shapes."""
    scores = b * (HEADS // MODEL) * S * BLOCK_K * F32
    return 3 * _attention_block() + 4 * scores + 2 * b * (
        HEADS // MODEL) * S * F32


def bound_attention_backward(_) -> int:
    """The rank's float32 (b, R / model, 1, S, hd) block 8 times (q scaled,
    the output and its gradient, dq and its sum, the kv gradients'
    blocks). The custom backward made its state like `q` already, so the
    plan before peaked the same here (0.94 MiB); its fault was the
    forward's."""
    return 8 * _attention_block()


def _embedding_bound(books: int) -> int:
    table = (VOCAB // MODEL) * D * F32  # the row block's gradient
    rows = b * S * D * F32  # the rank's output block
    return books * (table + 4 * rows + 4 * b * S * 8)


def bound_embedding(_) -> int:
    """The table's row block (V / model, D) as the gradient, the rank's
    output block (b, S, D) 4 times (the rows, their gradient, sorted) and
    the ids' int64 sort keys. The plan before peaked at 8.00 MiB, 6.4x
    this bound: the table gathered whole in the forward, and in the
    backward the gradient all-gathered over the batch and summed into
    the whole table on every rank."""
    return _embedding_bound(1)


def bound_embedding_audio(_) -> int:
    """`bound_embedding` twice for each codebook: each codebook's row
    block gradient, then the stacked (K, V / model, D) one. The plan
    before peaked at 8.02 MiB, 1.8x this bound (the whole table's
    gradient, K x V x D, is 4x the rank's block, and the stack doubles
    the rank's)."""
    return 2 * _embedding_bound(BOOKS)


def bound_mamba2(res) -> int:
    """The SSD's float32 per-chunk block on the rank's heads, (b, nc,
    H / model, Q, Q), 8 times: the decay and score matrices forward and
    backward dominate the block at this chunk. The plan before peaked at
    24.87 MiB, 3.1x this bound: the in-projection gathered whole and the
    SSD run on every head."""
    _, _, h, _, _, q, _ = res["cfg"]
    return 8 * b * (SSM_S // q) * (h // MODEL) * q * q * F32


BOUNDS = {name: globals()[f"bound_{name}"] for name in REGIONS}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    out = tmp_path_factory.mktemp("regions") / "regions.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, str(SCRIPT), str(out)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=JOIN_S)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("name", list(REGIONS))
def test_region_peak_within_its_local_blocks(counts, name):
    res = counts[name]
    bound = BOUNDS[name](res)
    assert 0 < res["peak"] <= bound, (
        f"{name}: temporaries peak at {_mb(res['peak'])}, above the bound "
        f"{_mb(bound)} from the rank's local blocks")


if __name__ == "__main__":
    main(Path(sys.argv[1]))
