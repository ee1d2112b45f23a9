"""A run's line and its refusals, on the CPU at tiny sizes: the keys of the
last line, no module of JAX or of the JAX package loaded, a reference that
imports nothing of the program, no result without the program or a card,
and a run with its timed path broken underneath coming out not correct."""
from __future__ import annotations

import ast
import dataclasses
import json
import subprocess
import sys

import pytest
import torch
from conftest import ROOT

from bench import run
from bench.spec import load_cell

CPU = torch.device("cpu")
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("workload", ["ml1m.bulk", "cat1m.bulk"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(tiny, capsys, workload, trace):
    cell = load_cell(tiny, workload)
    out = run.run_cell(cell, 2**31 + 11, 2.0, trace, CPU)
    run.print_line(out)
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    extra = {"checks", "breakdown"} if trace else {"checks"}
    assert set(line) == LINE_KEYS | extra
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0, captured.err[-2000:]
    want = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(line["metrics"]) == {"qps", "batch_p95_ms", "setup_s"}
    for name, c in line["checks"].items():
        assert f"check {name} {c['value']!r} limit {c['limit']!r}" in \
            captured.err


def test_no_jax_or_jax_package_loaded(tiny):
    """A whole run in a fresh process leaves no `jax`, `jaxlib`, `flax` or
    `repro` (top-level names, compared whole) in `sys.modules`."""
    script = (
        "import json, sys, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from pathlib import Path\n"
        "from bench import run\n"
        f"cell = run.load_cell(Path({str(tiny)!r}), 'ml1m.bulk')\n"
        "run.run_cell(cell, 3, 2.0, True, torch.device('cpu'))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "bench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in {
                    "repro_torch", "repro", "jax", "jaxlib", "flax", "bench"
                }, f"{path.name} imports {name}"
    script = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}]\n"
        "from pathlib import Path\n"
        "import torch\n"
        "from bench.spec import load_cell, load_module\n"
        "from bench.generator import make_pool\n"
        "from bench.weights import make_weights\n"
        f"cell = load_cell(Path({str(ROOT)!r}), 'ml1m.bulk')\n"
        "cfg = dict(cell.config, n_items=200)\n"
        "ref = load_module(cell.root, 'reference', cfg['reference'])\n"
        "r = ref.Reference(*make_weights(cfg, 1, 'cpu'), cfg)\n"
        "b = make_pool(cfg, dict(cell.traffic, batch=8, pool_batches=1), 1,\n"
        "              'cpu')\n"
        "out = r.serve({k: torch.from_numpy(v) for k, v in b[0].items()})\n"
        "assert out['items'].shape == (8, cfg['top_k'])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "repro_torch" not in proc.stdout and "'repro'" not in proc.stdout


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and bench/: exit code not 0,
    nothing on standard output."""
    import shutil

    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "ml1m.bulk", "--seed",
         "1", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, timeout=120, cwd=tmp_path, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "the program is not in this checkout" in proc.stderr


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "ml1m.bulk", "--seed",
         str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def _half_left_out(r):
    h = r.items.shape[0] // 2
    items, scores = r.items.clone(), r.topk.scores.clone()
    items[h:], scores[h:] = -1, float("-inf")
    nns = r.nns._replace(indices=r.nns.indices.clone(),
                         distances=r.nns.distances.clone(),
                         counts=r.nns.counts.clone())
    nns.indices[h:], nns.distances[h:], nns.counts[h:] = -1, 2**30, 0
    return r._replace(items=items, topk=r.topk._replace(scores=scores),
                      nns=nns)


def _answer_altered(r):
    items = r.items.clone()
    items[0, 0] = r.nns.indices[0, -1] if int(r.nns.indices[0, -1]) != int(
        items[0, 0]) else r.nns.indices[0, -2]
    return r._replace(items=items)


@pytest.mark.parametrize("workload", ["ml1m.bulk", "cat1m.bulk"])
@pytest.mark.parametrize("fault", [None, _half_left_out, _answer_altered])
def test_broken_timed_path_is_not_correct(tiny, monkeypatch, workload, fault):
    """The run's own path, with the program's entry broken underneath: half
    of each batch left unanswered, or one answer a batch altered where it
    is produced, comes out not correct; the unbroken run, correct."""
    from repro_torch.serving import recsys_engine

    if fault is not None:
        serve = recsys_engine.RecSysEngine.serve
        monkeypatch.setattr(recsys_engine.RecSysEngine, "serve",
                            lambda self, batch: fault(serve(self, batch)))
    out = run.run_cell(load_cell(tiny, workload), 2**31 + 3, 2.0, False, CPU)
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("workload", ["ml1m.bulk", "cat1m.bulk"])
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 9])
def test_control_is_not_correct(tiny, workload, seed):
    """The reference one precision below (TF32 operands), run as the system
    in the program's place through the run's own loop and comparison,
    comes out not correct, at tiny sizes."""
    cell = load_cell(tiny, workload)
    cell = dataclasses.replace(
        cell, config={**cell.config, "system": "youtubednn_tf32_control"})
    out = run.run_cell(cell, seed, 2.0, False, CPU)
    assert out["correct"] is False, out["checks"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.cuda
def test_cells_run_on_the_card(cuda_device):
    """Each cell, 2 s on the card through the command: exit 0, the line's
    keys, correct."""
    for w in ("ml1m.bulk", "cat1m.bulk"):
        proc = subprocess.run(
            [sys.executable, "bench/run.py", "--workload", w, "--seed",
             str(2**31 + 17), "--seconds", "2", "--trace", "1"],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["correct"] is True and line["device"]["busy_s"] > 0
