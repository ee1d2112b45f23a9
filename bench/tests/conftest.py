"""Fixtures of the benchmark's own tests: the checkout's root and `src/` on
the path, and a temporary copy of the benchmark cut to tiny sizes, which
runs on the CPU through the port's plain kernel versions.

    PYTHONPATH=src python -m pytest -q bench/tests
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
# tiny sizes need few threads; more only contend with parallel workers
torch.set_num_threads(2)
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# tiny sizes of each configuration and mix; everything else as committed
TINY_CONFIGS = {"youtubednn-ml1m": {"n_items": 300},
                "youtubednn-cat1m": {"n_items": 4096, "scan_block": 1024}}
TINY_TRAFFIC = {"batch": 48, "pool_batches": 3, "warm_batches": 2,
                "sample_batches": 3, "trace_batches": 4}


def tiny_checkout(dest: Path) -> Path:
    """`BENCHMARK.json` and `bench/` copied to `dest`, every configuration
    and mix cut to tiny sizes, and `src/` linked to the checkout's."""
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    (dest / "src").symlink_to(ROOT / "src")
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY_CONFIGS.get(c["name"], {}))
        path.write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        path = dest / "bench" / "traffic" / f"{w['traffic']}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()),
                                    **TINY_TRAFFIC}))
    return dest


@pytest.fixture
def tiny(tmp_path) -> Path:
    return tiny_checkout(tmp_path / "checkout")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run
    time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda", 0)
