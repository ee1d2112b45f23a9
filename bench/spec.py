"""`BENCHMARK.json` and the files it names, resolved for one cell.

A cell names a configuration and a traffic mix; each metric names its
reader. They are found by name, so a later cell, configuration, mix or
metric is a new file and a new entry, never an edit:

- configuration ``c``: the `file` its entry in `configs` gives (a JSON
  object; its `system` and `reference` keys name `systems/<system>.py` and
  `reference/<reference>.py`);
- traffic mix ``t``: `traffic/<t>.json`;
- per-layer metric ``m``: `metrics/<m>.py`, whose `read(ctx)` returns the
  value or None.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class Cell:
    root: Path  # the checkout: BENCHMARK.json and the program's src/
    name: str
    chips: int
    config: dict  # the configuration file's object, plus its entry's name
    traffic: dict  # the traffic file's object, plus "name"
    end_to_end: list  # the end-to-end metrics this cell reports
    per_layer: list  # the per-layer metrics this cell reports


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, workload: str) -> Cell:
    """The cell `workload` of `root/BENCHMARK.json`, its files read."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(known: {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = {**load_json(root / entry["file"]), "name": entry["name"]}
    traffic_file = root / "bench" / "traffic" / f"{w['traffic']}.json"
    traffic = {**load_json(traffic_file), "name": w["traffic"]}
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return Cell(root=root, name=workload, chips=int(w["chips"]),
                config=config, traffic=traffic, end_to_end=e2e,
                per_layer=per_layer)


def load_module(root: Path, kind: str, name: str):
    """`<root>/bench/<kind>/<name>.py` as a module (a name may hold dots,
    so the file is loaded by its path)."""
    path = root / "bench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up
    spec.loader.exec_module(module)
    return module
