"""`BENCHMARK.json` against its contract's forms, every name resolved to its
file, and a configuration, a mix and a metric added as new files found
with no other edit."""
from __future__ import annotations

import json
import re
import subprocess
import sys

from conftest import ROOT

from bench.spec import load_cell, load_module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def bench_json() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_forms():
    b = bench_json()
    assert set(b) == TOP_KEYS
    assert b["command"] == ["python3", "bench/run.py"]
    assert b["paths"] == ["bench"]
    assert 1 <= b["run_seconds"] <= 51
    metrics = b["end_to_end"] + b["per_layer"]
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in metrics])
    assert len(set(names)) == len(names)
    for name in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(name), name
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_name_resolves_to_its_file():
    b = bench_json()
    for w in b["workloads"]:
        cell = load_cell(ROOT, w["name"])
        load_module(ROOT, "systems", cell.config["system"])
        ref = load_module(ROOT, "reference", cell.config["reference"])
        assert callable(ref.judge) and callable(ref.aggregate)
        assert set(cell.config["limits"]) == {"scan_miss", "ctr_err",
                                              "rank_gap"}
        loop = load_module(ROOT, "loops", cell.traffic["loop"])
        assert callable(loop.end_to_end) and callable(loop.Loop)
        assert cell.per_layer and len(cell.end_to_end) >= 2
    for m in b["per_layer"]:
        assert callable(load_module(ROOT, "metrics", m["name"]).read)


def test_new_config_mix_and_metric_are_found_by_name(tiny):
    """Files added to a copy, and entries in its BENCHMARK.json: the copy's
    harness runs the new cell and reads the new metric."""
    (tiny / "bench" / "configs" / "youtubednn-tiny.json").write_text(
        json.dumps({**json.loads((tiny / "bench" / "configs" /
                                  "youtubednn-ml1m.json").read_text()),
                    "n_items": 200}))
    (tiny / "bench" / "traffic" / "bulk-b40.json").write_text(json.dumps(
        {**json.loads((tiny / "bench" / "traffic" /
                       "bulk-b32768.json").read_text()),
         "depth": 3, "batch": 40, "pool_batches": 2, "warm_batches": 2,
         "sample_batches": 2, "trace_batches": 3}))
    (tiny / "bench" / "metrics" / "batches_traced.py").write_text(
        '"""Batches in the traced window."""\n\n\n'
        "def read(ctx):\n    return len(ctx.trace.batches)\n")
    b = json.loads((tiny / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "youtubednn-tiny", "source": "a test",
                         "file": "bench/configs/youtubednn-tiny.json",
                         "reduced": ["n_items"], "why": "a test"})
    b["workloads"].append({"name": "tiny.bulk", "config": "youtubednn-tiny",
                           "traffic": "bulk-b40", "chips": 1,
                           "why": "a test"})
    b["per_layer"].append({"name": "batches_traced", "unit": "batches",
                           "better": "higher", "source": "program_counter",
                           "layer": "entry", "moves": "qps",
                           "workloads": ["tiny.bulk"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(b))
    script = (
        "import json, sys, torch\n"
        f"sys.path[:0] = [{str(tiny)!r}, {str(ROOT / 'src')!r}]\n"
        "from pathlib import Path\n"
        "from bench import run\n"
        f"cell = run.load_cell(Path({str(tiny)!r}), 'tiny.bulk')\n"
        "out = run.run_cell(cell, 5, 2.0, True, torch.device('cpu'))\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=240, cwd=tiny)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["metrics"]["batches_traced"]["value"] == 3
    assert out["attempted"] % 40 == 0


def test_prefix_lengths_follow_the_rating_log():
    """A batch's history lengths: MovieLens-1M's 6,040 users send one query
    of each length 1..19 and the rest of their 1,000,209 ratings' queries
    carry all 20 items (88.5%); the shares sum to the batch."""
    from bench.generator import prefix_lengths

    mix = json.loads((ROOT / "bench" / "traffic" /
                      "bulk-b32768.json").read_text())
    lengths = prefix_lengths(mix, 20, 32768)
    assert lengths.size == 32768 and lengths.min() == 1
    counts = [int((lengths == n).sum()) for n in range(1, 21)]
    assert all(c in (197, 198) for c in counts[:-1])
    assert abs(counts[-1] / 32768 - (1 - 19 * 6040 / 1000209)) < 1e-4


def test_seeds_order_the_same_queries(tiny):
    """Two seeds give the same queries in other orders, batch by batch;
    one seed gives the same batches twice."""
    import numpy as np
    import torch

    from bench.generator import make_pool

    def rows(batch):
        cols = [batch[k].reshape(len(batch["genre"]), -1)
                for k in sorted(batch)]
        return np.concatenate(cols, 1)

    def key(batch):
        return sorted(map(tuple, rows(batch).tolist()))

    cell = load_cell(tiny, "ml1m.bulk")
    a, b, a2 = (make_pool(cell.config, cell.traffic, s, torch.device("cpu"))
                for s in (7, 2**31 + 7, 7))
    for x, x2 in zip(a, a2):
        assert all(np.array_equal(x[k], x2[k]) for k in x)
    assert sorted(map(key, a)) == sorted(map(key, b))
    assert any(not np.array_equal(rows(x), rows(y)) for x, y in zip(a, b))
