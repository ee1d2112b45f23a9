"""Multi-pod dry run: the counterpart of `repro/launch/dryrun.py`. Each
(arch x shape x mesh) cell builds its step on the production mesh, (16,
16) = 256 ranks or (2, 16, 16) = 512, runs it once as rank 0 of a `fake`
process group, and records that rank's memory and op counts (flops, HBM
bytes, collective bytes by kind: `launch/hlo_analysis.py`) into
`experiments/dryrun_torch/<cell>.json`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]

How a cell runs: the step's inputs are fake tensors (shapes and dtypes,
no storage), placed with `BuiltStep.shard` on the mesh; the step runs
outside the fake mode, so DTensor propagates its shardings on real
metadata, and its local ops reach the fake tensors, where
`FakeOpRecorder` counts them. Tensors made mid-step by factory calls
(no tensor input) are made fake too; a real tensor of more than 1 MiB
reaching an op fails the cell. The decode index is a real int32 scalar,
`seq_len - 1` (the step reads it on the host). The fake group runs no
collective, and the cell allocates no device memory anywhere: it is the
counterpart of the reference's placeholder host devices, and it does the
same with or without a GPU (it never looks for one; this is no CPU
fallback of a card run).

A cell's JSON holds the reference's keys but `xla_cost_analysis`, which
has no counterpart: `memory`, the rank's tensor bytes through the step
(`_LiveBytes`: `argument_bytes` its input blocks, `output_bytes`,
`temp_bytes` the peak of live bytes less the arguments, `alias_bytes`
the outputs that share an input's storage: the decode's in-place
caches; `generated_code_bytes` 0), `hlo` (`analyze_ops`), `timings_s`
(`build`, `run`) and `kv_repeat`.
Each cell's op records go gzipped beside its JSON (`.ops.gz`, the
reference's `.hlo.gz`); `--reanalyze` recomputes `hlo` from them. A
cell that raises is written with `status` "error" and its traceback,
and the run exits 1: such a failure is a bug.
"""
from __future__ import annotations

import argparse
import gzip
import json
import pathlib
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.hlo_analysis import (
    FakeOpRecorder,
    OpRecord,
    analyze_ops,
    check_real,
)

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")
MAX_REAL_BYTES = 1 << 20


class _FakeFactories(TorchDispatchMode):
    """Over the step, at DTensor's level: a call with no tensor input (a
    factory: `torch.zeros`, `arange`, ...) runs in `fake_mode`, so what
    the step makes mid-step is fake too; any other call runs as it is
    (DTensor's own dispatch beneath this mode, with no fake mode active),
    after its real tensors are checked against `MAX_REAL_BYTES`."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
        if not tensors:
            with self.fake_mode:
                return func(*args, **kwargs)
        check_real(tensors, MAX_REAL_BYTES, func)
        return func(*args, **kwargs)


class _LiveBytes(TorchDispatchMode):
    """One rank's live tensor bytes through the step and their peak, each
    storage counted once from the op that made it until it is freed: the
    inputs, and every tensor an op makes on `fake_mode`'s tensors, the
    step's factory calls included. DTensor's shape inference, on fake
    tensors of its own mode, does not count, nor does `wait_tensor`'s
    fake result (its input's stand-in). `MemTracker` gives the same
    peak on torch 2.13, but 2.11's counts DTensor's shape inference at
    the global shapes too."""

    def __init__(self, fake_mode, inputs):
        super().__init__()
        self.fake_mode = fake_mode
        self.sizes: dict = {}
        self.now = self.peak = 0
        for t in inputs:
            self._track(t)

    def _track(self, t) -> None:
        import weakref

        from torch.multiprocessing.reductions import StorageWeakRef

        st = t.untyped_storage()
        key = StorageWeakRef(st)
        if key in self.sizes:
            return
        self.sizes[key] = st.nbytes()
        self.now += st.nbytes()
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.now -= self.sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it as local ops, seen here
        out = func(*args, **(kwargs or {}))
        if func is not torch.ops._c10d_functional.wait_tensor.default:
            for t in torch.utils._pytree.tree_leaves(out):
                if isinstance(t, FakeTensor) and t.fake_mode is self.fake_mode:
                    self._track(t)
        return out


def fake_group(world: int) -> None:
    """Make this process rank 0 of a `fake` group of `world` ranks (a
    fake group of another size is replaced; any other group refuses)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"dry run: this process already runs a "
                f"{dist.get_backend()} group; the dry run needs a process "
                f"of its own")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _locals(tree) -> list:
    from repro_torch.distributed.sharding import is_dtensor, tree_items

    return [t.to_local() if is_dtensor(t) else t
            for _, t in tree_items(tree)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _storages(tensors) -> set:
    from torch.multiprocessing.reductions import StorageWeakRef

    return {StorageWeakRef(t.untyped_storage()) for t in tensors}


def dry_run(bundle, shape, mesh_dims: tuple,
            ops_path: pathlib.Path | None = None) -> dict:
    """One step of `bundle` at `shape` (a `ShapeConfig`) on a mesh of
    `mesh_dims`, run as rank 0 of a fake group of that many ranks ->
    the cell's `n_devices`, `memory`, `hlo`, `timings_s`, `kv_repeat`."""
    from repro_torch.distributed.sharding import map_tree
    from repro_torch.launch.mesh import make_mesh_of
    from repro_torch.launch import steps

    n_devices = 1
    for d in mesh_dims:
        n_devices *= d
    t0 = time.time()
    fake_group(n_devices)
    mesh = make_mesh_of(mesh_dims, "cpu")
    built = {"train": steps.build_train_step,
             "prefill": steps.build_prefill_step,
             "decode": steps.build_decode_step}[shape.kind](bundle, shape,
                                                            mesh)
    fake = FakeOpRecorder(MAX_REAL_BYTES)
    with fake:
        args = [map_tree(lambda _, t: torch.empty(t.shape, dtype=t.dtype),
                         a) for a in built.abstract_args]
    if shape.kind == "decode":  # read on the host: a real scalar
        args[-1] = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
    args = [built.shard(i, a) for i, a in enumerate(args)]
    t_build = time.time() - t0
    inputs = _locals(args)
    fake.records.clear()  # placing the inputs is not the step's work
    live = _LiveBytes(fake, inputs)
    with live, _FakeFactories(fake):
        out = built.fn(*args)
    t_run = time.time() - t0 - t_build
    outputs = _locals(out)
    peak = live.peak
    arg_bytes = _nbytes(inputs)
    ins = _storages(inputs)
    aliased = [t for t in outputs if _storages([t]) <= ins]
    records = fake.records
    if ops_path is not None:
        with gzip.open(ops_path, "wt") as f:
            json.dump([r.to_json() for r in records], f)
    return {
        "n_devices": n_devices,
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": _nbytes(outputs),
                   "temp_bytes": peak - arg_bytes,
                   "alias_bytes": _nbytes(aliased),
                   "generated_code_bytes": 0},
        "hlo": analyze_ops(records, n_devices).as_dict(),
        "timings_s": {"build": round(t_build, 2), "run": round(t_run, 2)},
        "kv_repeat": built.cfg.kv_repeat,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             override_parallel: dict | None = None,
             ops_path: pathlib.Path | None = None,
             override_model: dict | None = None) -> dict:
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_arch

    bundle = get_arch(arch)
    if override_parallel or override_model:
        bundle = type(bundle)(
            model=bundle.model.with_(**(override_model or {})),
            parallel=bundle.parallel.with_(**(override_parallel or {})),
            skip_shapes=bundle.skip_shapes,
        )
    mesh_name = "multi" if multi_pod else "single"
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if shape_name in dict(bundle.skip_shapes):
        return {**cell, "status": "skipped",
                "reason": dict(bundle.skip_shapes)[shape_name]}
    dims = (2, 16, 16) if multi_pod else (16, 16)
    return {**cell, "status": "ok",
            **dry_run(bundle, SHAPES[shape_name], dims, ops_path)}


def cell_path(arch, shape, mesh_name, tag="") -> pathlib.Path:
    safe = arch.replace(".", "_").replace("/", "_")
    suffix = f"__{tag}" if tag else ""
    return OUT_DIR / f"{safe}__{shape}__{mesh_name}{suffix}.json"


def ops_path_of(path: pathlib.Path) -> pathlib.Path:
    return path.with_suffix(".ops.gz")


def reanalyze(path: pathlib.Path) -> dict:
    """The cell at `path` with `hlo` recomputed from its saved records."""
    res = json.loads(path.read_text())
    with gzip.open(ops_path_of(path), "rt") as f:
        records = [OpRecord.from_json(r) for r in json.load(f)]
    res["hlo"] = analyze_ops(records, res.get("n_devices", 1)).as_dict()
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", type=str, default="",
                    help="variant tag for perf-iteration runs")
    ap.add_argument("--override", type=str, default=None,
                    help="JSON dict of ParallelConfig overrides")
    ap.add_argument("--model-override", type=str, default=None,
                    help="JSON dict of ModelConfig overrides")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--reanalyze", action="store_true",
                    help="recompute the op stats from saved .ops.gz (no "
                         "run)")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ARCH_IDS

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    arches = ARCH_IDS if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh]
    override = json.loads(args.override) if args.override else None
    override_model = (json.loads(args.model_override)
                      if args.model_override else None)
    cells = [(a, s, "multi" if mp else "single", mp)
             for a in arches for s in shapes for mp in meshes]

    if args.reanalyze:
        for arch, shape, mesh_name, _ in cells:
            path = cell_path(arch, shape, mesh_name, args.tag)
            if path.exists() and ops_path_of(path).exists():
                path.write_text(json.dumps(reanalyze(path), indent=1))
                print(f"[reanalyzed] {path.name}")
        return

    failures = 0
    for arch, shape, mesh_name, mp in cells:
        path = cell_path(arch, shape, mesh_name, args.tag)
        if path.exists() and not args.force:
            print(f"[skip-cached] {path.name}")
            continue
        print(f"[run] {arch} x {shape} x {mesh_name} ...", flush=True)
        t0 = time.time()
        try:
            res = run_cell(arch, shape, mp, override,
                           ops_path=ops_path_of(path),
                           override_model=override_model)
        except Exception as e:  # record the failure: it is a bug
            failures += 1
            res = {
                "arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:],
            }
        if args.tag:
            res["tag"] = args.tag
        path.write_text(json.dumps(res, indent=1))
        print(f"  -> {res['status']} ({time.time() - t0:.1f} s)",
              flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
