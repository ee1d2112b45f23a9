"""The port's dry run (`repro_torch/launch/dryrun.py`) against the
reference's (`src/repro/launch/dryrun.py`) on reduced cells.

Cells: the reduced bundles of `tests/test_torch_sharding_ranks.py`'s
`tiny_bundle` (2 layers, accumulation 2, logit chunks of 16) on the (2,
4) test mesh: qwen2.5-3b train (64 tokens x 8), prefill (64 x 4) and
decode (a 64-row cache x 8), qwen2.5-3b train with `remat="none"`,
mamba2-1.3b train and phi3.5-moe train. Each port cell runs in a
subprocess of its own as rank 0 of an 8-rank `fake` group (the group is
process-wide); the reference's cells compile in one subprocess on 8
placeholder host devices, as `tests/helpers/mini_dryrun.py` does. All
run at once.

One rank's argument bytes equal the reference's `memory_analysis()`
exactly: the port places every input on the reference's specs.

Per-rank flops equal the reference's plus an amount whose every term
comes from one named cause, so each cell is held to the reference's
flops plus that amount, exactly (the tolerance is 0 flops). The prefill,
decode and `remat="none"` cells count the reference's flops: the gap is
0.

- train, attention under `remat="block"`: the remat's recomputed forward
  computes the blocked attention's scores q k^T, and the custom backward
  computes them again from the same q and k. In the reference both dots
  sit in one backward computation and XLA's CSE merges them; the port
  runs both. One q k^T a layer and microbatch more: 2 B_r (H / model)
  S^2 hd flops, B_r the rank's microbatch rows.
- mamba2 train: the reference contracts the decay operand's gradient of
  the two three-operand einsums (`states`, `y_off`) as a dot, 2 B_r S
  (H / model) P flops each, where torch multiplies and sums (no dot, so
  no flops counted): the gap is minus those. The SSD runs on the rank's
  H / model heads, as the reference's does.
- phi3.5-moe train: the attention's term above, and two of the expert
  layer's. A microbatch's T tokens form T / gsz dispatch groups of gsz;
  a rank holds its groups (all of them where the data axis does not
  divide their count, as here: both sides gather a group's tokens), its
  E / model experts and C slots an expert. (1) The reference's remat
  drops the recomputed combine product (its output is not needed by
  the backward; XLA removes it), the port's checkpoint runs it: one 2
  T_g (E / model) C D product a layer and microbatch more, T_g the
  rank's group tokens. (2) The reference routes the rank's own B_r S
  tokens and gathers the gates, the port routes its T_g group tokens: 4
  products of 2 (T_g - B_r S) D E more (the router's forward,
  recomputed forward and two gradients). Both sides run the same other
  products of the expert layer: the dispatch and combine (2 T_g (E /
  model) C D each) and the expert FFN (2 (E / model) C D F each).
"""
import gzip
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = Path(__file__).resolve()
MESH = (2, 4)  # (data, model)
TRAIN = ("tiny_train", "train", 64, 8)
# name -> (arch, (shape name, kind, seq_len, global batch), parallel
# overrides, (data, model))
CELLS = {
    "qwen-train": ("qwen2.5-3b", TRAIN, {}, MESH),
    "qwen-train-noremat": ("qwen2.5-3b", TRAIN, {"remat": "none"}, MESH),
    "qwen-prefill": ("qwen2.5-3b", ("tiny_prefill", "prefill", 64, 4), {},
                     MESH),
    "qwen-decode": ("qwen2.5-3b", ("tiny_decode", "decode", 64, 8), {},
                    MESH),
    "mamba-train": ("mamba2-1.3b", TRAIN, {}, MESH),
    "moe-train": ("phi3.5-moe-42b-a6.6b", TRAIN, {}, MESH),
    # one rank: the dry run beside a real step on a gloo group of one
    "qwen-train-1": ("qwen2.5-3b", TRAIN, {}, (1, 1)),
}
PORT_JOBS = [n for n in CELLS if n != "qwen-train-1"] + ["world1"]
ACCUM = 2
JOIN_S = 240.0


def tiny_bundle(pkg, name: str):
    """Cell `name`'s bundle from either package (`pkg` "repro" or
    "repro_torch"): `tiny_bundle` of `tests/test_torch_sharding_ranks.py`
    with the cell's parallel overrides."""
    import importlib

    base = importlib.import_module(f"{pkg}.configs.base")
    reduced = importlib.import_module(f"{pkg}.configs.reduced")
    registry = importlib.import_module(f"{pkg}.configs.registry")
    arch, _, parallel, _ = CELLS[name]
    b = registry.get_arch(arch)
    cfg = reduced.reduce_config(b.model)
    cfg = cfg.with_(n_layers=3 if cfg.family == "hybrid" else 2)
    return base.ArchBundle(model=cfg, parallel=b.parallel.with_(
        grad_accum={"tiny_train": ACCUM}, logit_chunk=16, **parallel),
        skip_shapes={})


def explained_gap(name: str) -> int:
    """The port's per-rank flops less the reference's (the module
    docstring gives each cause)."""
    _, (_, kind, S, B), _, (data, model) = CELLS[name]
    bundle = tiny_bundle("repro_torch", name)
    cfg, L = bundle.model, bundle.model.n_layers
    if kind != "train":
        return 0
    Br = B // ACCUM // data
    if cfg.family == "ssm":
        H, P = cfg.d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim
        return -L * ACCUM * 2 * 2 * Br * S * (H // model) * P
    if bundle.parallel.remat == "none":
        return 0
    gap = L * ACCUM * 2 * Br * (cfg.n_heads // model) * S * S * \
        cfg.head_dim
    if cfg.family == "moe":
        from repro_torch.models.moe import capacity

        E, D = cfg.n_experts, cfg.d_model
        gsz, cap = capacity(cfg, Br * data * S)
        groups = Br * data * S // gsz
        rank_groups = groups // data if groups % data == 0 else groups
        tokens = rank_groups * gsz  # the rank's tokens in its groups
        gap += L * ACCUM * 2 * tokens * (E // model) * cap * D  # combine
        gap += L * ACCUM * 4 * 2 * (tokens - Br * S) * D * E  # router
    return gap


# ---------------------------------------------------------------------------
# the subprocesses (this file's __main__)
# ---------------------------------------------------------------------------
def port_cell(name: str, out_dir: Path) -> None:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    ops = out_dir / f"{name}.ops.gz"
    _, shape, _, mesh = CELLS[name]
    res = dryrun.dry_run(tiny_bundle("repro_torch", name),
                         ShapeConfig(*shape), mesh, ops)
    assert "jax" not in sys.modules and "repro" not in sys.modules
    (out_dir / f"{name}.json").write_text(json.dumps(res))


def world1(out_dir: Path) -> None:
    """`qwen-train-1`: a real step on a one-rank gloo group under
    `OpRecorder` (what the card's phase M.1 records), then the dry run of
    the same cell."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import training as tr
    from repro_torch.launch import steps
    from repro_torch.launch.hlo_analysis import OpRecorder, analyze_ops
    from repro_torch.launch.mesh import make_mesh_of

    name = "qwen-train-1"
    bundle = tiny_bundle("repro_torch", name)
    shape = ShapeConfig(*CELLS[name][1])
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/rendezvous", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    built = steps.build_train_step(bundle, shape, make_mesh_of((1, 1),
                                                               "cpu"))
    gen = torch.Generator().manual_seed(0)
    state = built.shard(0, tr.init_train_state(built.cfg, bundle.parallel,
                                               gen, "cpu"))
    batch = built.shard(1, {k: torch.randint(
        0, built.cfg.vocab_size, tuple(v.shape), dtype=v.dtype,
        generator=gen) for k, v in built.abstract_args[1].items()})
    with OpRecorder() as rec:
        built.fn(state, batch)
    dist.destroy_process_group()
    (out_dir / "real.json").write_text(json.dumps(
        analyze_ops(rec.records, 1).as_dict()))
    port_cell(name, out_dir)


def _reference(out_dir: Path) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from repro.configs.base import ShapeConfig
    from repro.launch import steps
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.launch.mesh import _make_mesh

    out = {}
    for name, (_, shape, _, dims) in CELLS.items():
        shp = ShapeConfig(*shape)
        build = {"train": steps.build_train_step,
                 "prefill": steps.build_prefill_step,
                 "decode": steps.build_decode_step}[shp.kind]
        mesh = _make_mesh(dims, ("data", "model"))
        with mesh:
            built = build(tiny_bundle("repro", name), shp, mesh)
            co = built.fn.lower(*built.abstract_args).compile()
        n = dims[0] * dims[1]
        out[name] = {"flops": analyze_hlo(co.as_text(), n).flops,
                     "argument_bytes":
                         co.memory_analysis().argument_size_in_bytes}
    (out_dir / "reference.json").write_text(json.dumps(out))


ERROR_CELL = ["--arch", "qwen3-8b", "--shape", "train_4k", "--override",
              json.dumps({"grad_accum": {"train_4k": 3}})]


def _error_main(out_dir: Path) -> None:
    """The CLI on a cell that raises (256 does not split into 3
    microbatches), writing under `out_dir`."""
    from repro_torch.launch import dryrun

    dryrun.OUT_DIR = out_dir
    dryrun.main(ERROR_CELL)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess at once -> (their directory, {job: returncode
    and output})."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    jobs = {name: ["port", name] for name in PORT_JOBS}
    jobs["reference"] = ["reference"]
    jobs["error"] = ["error"]
    for job in jobs:
        (out / job).mkdir()
    procs = {job: subprocess.Popen(
        [sys.executable, str(SCRIPT), *argv, str(out / job)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for job, argv in jobs.items()}
    results = {}
    try:
        for job, p in procs.items():
            text, _ = p.communicate(timeout=JOIN_S)
            results[job] = (p.returncode, text[-4000:])
    finally:
        for p in procs.values():
            p.kill()
    return out, results


def _ok(runs, job):
    out, results = runs
    rc, text = results[job]
    assert rc == 0, f"{job} exited {rc}:\n{text}"
    return out / job


@pytest.fixture(scope="module")
def reference(runs):
    return json.loads((_ok(runs, "reference") / "reference.json")
                      .read_text())


def _cell(runs, name):
    job = "world1" if name == "qwen-train-1" else name
    return json.loads((_ok(runs, job) / f"{name}.json").read_text())


@pytest.mark.parametrize("name", list(CELLS))
def test_argument_bytes_equal_reference(runs, reference, name):
    cell = _cell(runs, name)
    dims = CELLS[name][3]
    assert cell["n_devices"] == dims[0] * dims[1]
    assert cell["memory"]["argument_bytes"] == \
        reference[name]["argument_bytes"]
    mem = cell["memory"]
    assert mem["temp_bytes"] > 0 and mem["output_bytes"] > 0
    # the decode writes its caches in place and returns them
    assert (mem["alias_bytes"] > 0) == (name == "qwen-decode")


@pytest.mark.parametrize("name", list(CELLS))
def test_flops_equal_reference_plus_explained_gap(runs, reference, name):
    """Exactly: see the module docstring for each cell's gap."""
    cell = _cell(runs, name)
    gap = explained_gap(name)
    assert (gap == 0) == (name.endswith("noremat")
                          or CELLS[name][1][1] != "train")
    assert cell["hlo"]["flops"] == reference[name]["flops"] + gap, (
        cell["hlo"]["flops"], reference[name]["flops"], gap)
    assert (cell["hlo"]["collective_bytes"] > 0) == (cell["n_devices"] > 1)
    assert cell["hlo"]["hbm_bytes_eager"] >= cell["hlo"]["hbm_bytes"] > 0


def test_real_step_counts_equal_dry_run(runs):
    """A real one-rank step under `OpRecorder` counts what the dry run
    of the same cell counts: the same flops and HBM bytes."""
    real = json.loads((_ok(runs, "world1") / "real.json").read_text())
    dry = _cell(runs, "qwen-train-1")["hlo"]
    for key in ("flops", "hbm_bytes", "hbm_bytes_eager",
                "collective_bytes"):
        assert real[key] == dry[key], key


def test_reanalyze_round_trip(runs, tmp_path, monkeypatch):
    """`--reanalyze` recomputes `hlo` from a cell's saved records, equal
    to the cell's own."""
    from repro_torch.launch import dryrun

    src = _ok(runs, "qwen-train")
    cell = json.loads((src / "qwen-train.json").read_text())
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    path = dryrun.cell_path("qwen2.5-3b", "tiny_train", "single")
    path.write_text(json.dumps({**cell, "hlo": None}))
    dryrun.ops_path_of(path).write_bytes(
        (src / "qwen-train.ops.gz").read_bytes())
    with gzip.open(dryrun.ops_path_of(path), "rt") as f:
        assert len(json.load(f)) > 100
    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "tiny_train",
                 "--reanalyze"])
    assert json.loads(path.read_text())["hlo"] == cell["hlo"]


def test_error_cell_written_and_exit_1(runs):
    out, results = runs
    rc, text = results["error"]
    assert rc == 1, text
    cell = json.loads((out / "error" / "qwen3-8b__train_4k__single.json")
                      .read_text())
    assert cell["status"] == "error"
    assert "Traceback" in cell["traceback"] and cell["error"]


def test_skipped_cell(tmp_path, monkeypatch):
    """qwen3-8b x long_500k is in its `skip_shapes`: written `skipped`
    with the reason, nothing built, no process group started."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-8b", "--shape", "long_500k"])
    assert e.value.code == 0
    cell = json.loads(dryrun.cell_path("qwen3-8b", "long_500k", "single")
                      .read_text())
    assert cell["status"] == "skipped" and cell["reason"]
    assert not dist.is_initialized()


def test_live_bytes_peak():
    """The dry run's memory: each storage from the op that makes it (a
    factory call too, sent into the fake mode) until it is freed; views
    and in-place results add nothing."""
    import torch

    from repro_torch.launch.dryrun import _FakeFactories, _LiveBytes
    from repro_torch.launch.hlo_analysis import FakeOpRecorder

    kib = 1024
    fake = FakeOpRecorder()
    with fake:
        x = torch.empty(256, 256)  # 256 KiB
    live = _LiveBytes(fake, [x])
    with live, _FakeFactories(fake):
        y = x @ x  # + 256 KiB
        z = torch.zeros(512, 256)  # + 512 KiB: the peak, 1,024 KiB
        z.add_(1.0)[:, :8].t()
        del y  # - 256 KiB
        w = z.sum(0)  # + 1 KiB
    assert live.peak == 1024 * kib
    assert live.now == (256 + 512 + 1) * kib
    del w, z
    assert live.now == 256 * kib


def test_cell_path_names_as_the_reference():
    from repro.launch import dryrun as ref
    from repro_torch.launch import dryrun

    assert dryrun.OUT_DIR == ROOT / "experiments" / "dryrun_torch"
    for args in (("qwen3-8b", "train_4k", "single", ""),
                 ("phi3.5-moe-42b-a6.6b", "decode_32k", "multi", "v2")):
        assert dryrun.cell_path(*args).name == ref.cell_path(*args).name
        assert dryrun.cell_path(*args).parent == dryrun.OUT_DIR


def test_port_modules_import_no_jax():
    """The new modules import neither jax nor repro."""
    code = ("import sys; import repro_torch.launch.dryrun, "
            "repro_torch.launch.hlo_analysis; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr


if __name__ == "__main__":
    job, *rest = sys.argv[1:]
    if job == "port" and rest[0] == "world1":
        world1(Path(rest[1]))
    elif job == "port":
        port_cell(rest[0], Path(rest[1]))
    elif job == "reference":
        _reference(Path(rest[0]))
    else:
        _error_main(Path(rest[0]))
