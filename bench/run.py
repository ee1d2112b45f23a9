"""Run one cell of `BENCHMARK.json` on one CUDA device and print its line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--system <name>]

From the root of a checkout that holds `BENCHMARK.json`, `bench/` and the
program, `src/repro_torch`. Set-up makes the traffic pool and the weights
from the seed, builds the system (`bench/systems/<system>.py`, the
configuration's, or `--system`'s: the comparison's control) and serves
`warm_batches` batches; the window then drives the mix's loop
(`bench/loops/<loop>.py`) for `--seconds` seconds. `--trace 0` reports the
cell's end-to-end metrics (the loop's, and `setup_s`), `--trace 1` its
per-layer metrics, read by `bench/metrics/<name>.py` from the window's
counters and from a profiled run of `trace_batches` more batches.

Once the window has closed and the peak memory is read, the program's
state is freed and the batches sampled from the window (a reservoir drawn
from the seed) are compared with the configuration's plain reference
(`bench/reference/<reference>.py`): every number compared is printed
beside its limit, as the last lines of standard error and under the
line's last key, `checks`. The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics`, `device` (and with
`--trace 1`, `breakdown`).

No result is printed, and the exit code is not 0, when the program is
missing from the checkout, when CUDA has fewer devices than the cell asks
for, or when a module of JAX or of the JAX package is loaded once the
window has closed. A run that fails after that prints its line with
`correct` false and the cause before it on standard error, and exits 1.
Kernel builds go to `build/` in the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import tracing  # noqa: E402
from bench.generator import make_pool  # noqa: E402
from bench.spec import load_cell, load_module  # noqa: E402
from bench.weights import make_weights  # noqa: E402

T_IMPORTED = time.perf_counter()
T_PROGRAM = None  # when `load_program` had imported the program

# top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the program's and the toolchains' build and kernel caches, under the
# checkout at fixed paths
CACHE_DIRS = {"REPRO_TORCH_BUILD_DIR": "build/repro_torch",
              "TRITON_CACHE_DIR": "build/triton",
              "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "CUDA_CACHE_PATH": "build/cuda_cache"}


class NoResult(Exception):
    """A run that must print no result line (exit code 2)."""


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_program(root: Path):
    """The program under test, `src/repro_torch` of the checkout."""
    global T_PROGRAM
    src = root / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise NoResult(f"the program is not in this checkout: no "
                       f"{src / 'repro_torch'}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch

    where = Path(repro_torch.__file__).resolve()
    if src.resolve() not in where.parents:
        raise NoResult(f"repro_torch was loaded from {where}, not from {src}")
    T_PROGRAM = time.perf_counter()
    return repro_torch


class Reservoir:
    """`size` batches of the window, drawn from the seed as they land: the
    sample the reference judges. Each kept batch's served tensors and
    landed answers are copied into buffers allocated in set-up
    (`prepare`), so the window allocates nothing for the sample."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.slots, self.kept = size, 0, [], []
        self.rng = np.random.default_rng([seed, 1])

    @staticmethod
    def _what(landed, system) -> dict:
        items, scores = landed.answers  # what landed on the host
        return {**system.served(landed.result), "items": items,
                "scores": scores}

    def prepare(self, landed, system) -> None:
        if not self.slots:
            self.slots = [{k: torch.empty_like(v) for k, v in
                           self._what(landed, system).items()}
                          for _ in range(self.size)]

    def offer(self, landed, system) -> None:
        i, self.seen = self.seen, self.seen + 1
        at = i if i < self.size else int(self.rng.integers(0, i + 1))
        if at >= self.size:
            return
        slot = self.slots[at]
        for k, v in self._what(landed, system).items():
            slot[k].copy_(v)
        if at < len(self.kept):
            self.kept[at] = (landed.slot, slot)
        else:
            self.kept.append((landed.slot, slot))


def window_readings(cell, system, loop, sample, seconds: float,
                    trace: bool):
    """Drive the window -> (Window, counters); `sample` sees every batch
    that lands in it."""
    sums: dict = {}

    def on_land(landed, in_window):
        if not in_window:
            return
        sample.offer(landed, system)
        if trace:
            for k, v in system.counters(landed.result).items():
                sums[k] = sums[k] + v if k in sums else v

    # what set-up made lives on: later collections leave it unscanned
    gc.collect()
    gc.freeze()
    window = loop.run(seconds=seconds, on_land=on_land)
    gc.unfreeze()
    return window, {k: int(v) for k, v in sums.items()}


def report_window(window) -> None:
    """The window's batches on standard error: how many landed, the median
    and largest batch latency, and when the slowest ones were dispatched."""
    lat = [((b.landed - b.dispatched) * 1e3, b.dispatched - window.start)
           for b in window.landed]
    if not lat:
        return
    ms = sorted(x for x, _ in lat)
    slow = sorted(lat, reverse=True)[:5]
    print(f"window: {len(ms)} batches landed in {window.seconds:.3f} s; "
          f"batch ms median {ms[len(ms) // 2]:.3f}, max {ms[-1]:.3f}; "
          f"slowest at s " + ", ".join(f"{t:.2f} ({x:.1f} ms)"
                                       for x, t in slow), file=sys.stderr)


def judge_sample(cell, sample, pool: list, seed: int, device) -> dict:
    """The compared numbers of the sampled batches of `pool` (the host's
    copy of the traffic) against the reference, run on `device` after the
    program's state is gone."""
    cfg = cell.config
    ref_mod = load_module(cell.root, "reference", cfg["reference"])
    params, proj = make_weights(cfg, seed, device)
    ref = ref_mod.Reference(params, proj, cfg)
    del params
    parts = []
    for slot, served in sample.kept:
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pool[slot].items()}
        parts.append(ref_mod.judge(ref, batch,
                                   {k: v.to(device)
                                    for k, v in served.items()}))
    return ref_mod.aggregate(parts)


def run_cell(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of `cell`; the result line's object, with `checks`."""
    cfg, traffic = cell.config, cell.traffic
    loops = load_module(cell.root, "loops", traffic["loop"])
    cuda = device.type == "cuda"
    marks = [("start", T_START), ("imports", T_IMPORTED),
             ("program", max(T_PROGRAM or 0.0, T_IMPORTED))]
    if cuda:  # the device's context
        torch.zeros(1, device=device)
        marks.append(("cuda", time.perf_counter()))
    pool = make_pool(cfg, traffic, seed, device)
    marks.append(("traffic", time.perf_counter()))
    system = load_module(cell.root, "systems", cfg["system"]).System(
        cfg, traffic, seed, device, pool)
    marks.append(("system", time.perf_counter()))
    loop = loops.Loop(system, pool, traffic, device)
    sample = Reservoir(traffic["sample_batches"], seed)
    loop.run(batches=traffic["warm_batches"],
             on_land=lambda landed, _: sample.prepare(landed, system))
    if cuda:
        torch.cuda.synchronize(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - T_START
    print("setup: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b)
                                in zip(marks, marks[1:])), file=sys.stderr)

    window, counters = window_readings(cell, system, loop, sample, seconds,
                                       trace)
    report_window(window)
    metrics: dict = {}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda
                else "cpu", "count": cell.chips}
    breakdown = None
    if trace:
        tr = tracing.traced_run(loop, system, traffic["trace_batches"])
        ctx = SimpleNamespace(
            cfg=cfg, traffic=traffic, system=system, loop=loop,
            window=window, counters=counters, trace=tr,
            inputs=lambda slot: {k: v.to(device)
                                 for k, v in loop.pool[slot].items()})
        for m in cell.per_layer:
            value = load_module(cell.root, "metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
        del tr, ctx
    else:
        values = {**loops.end_to_end(window), "setup_s": setup_s}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    dev_info["memory_peak_bytes"] = (
        int(torch.cuda.max_memory_allocated(device)) if cuda else 0)

    attempted = window.attempted
    del system, loop, window
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers = judge_sample(cell, sample, pool, seed, device)
    print(f"judge: {len(sample.kept)} batches in "
          f"{time.perf_counter() - t_judge:.3f} s", file=sys.stderr)
    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    failed = 0  # a batch that raises ends the run, with correct false
    correct = (failed == 0 and bool(sample.kept)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def set_cache_dirs(root: Path) -> None:
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(root / rel)


def print_line(out: dict) -> None:
    for name, c in out.get("checks", {}).items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--system", help="a file of bench/systems to serve in "
                   "the program's place (the comparison's control)")
    args = p.parse_args(argv)
    try:
        cell = load_cell(ROOT, args.workload)
        if args.system:
            cell = dataclasses.replace(
                cell, config={**cell.config, "system": args.system})
        set_cache_dirs(ROOT)
        load_program(ROOT)
        if not torch.cuda.is_available():
            raise NoResult("no CUDA device: this benchmark runs on the card "
                           "only")
        if torch.cuda.device_count() < cell.chips:
            raise NoResult(f"{cell.name} asks for {cell.chips} CUDA devices;"
                           f" {torch.cuda.device_count()} are visible")
    except (NoResult, KeyError, FileNotFoundError) as e:
        print(f"bench: no result: {e}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       device)
    except Exception:  # the run's boundary: report, and say why
        traceback.print_exc()
        print("bench: the run failed (above); correct is false",
              file=sys.stderr)
        out = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
               "device": {"platform": "gpu", "count": cell.chips,
                          "kind": torch.cuda.get_device_name(device),
                          "memory_peak_bytes": int(
                              torch.cuda.max_memory_allocated(device))}}
    bad = forbidden_modules()
    if bad:
        print(f"bench: no result: loaded {', '.join(bad)} (JAX or the JAX "
              f"package) in the measuring process", file=sys.stderr)
        return 3
    print_line(out)
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
