"""The benchmark of the PyTorch/CUDA port (`src/repro_torch`).

`python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of `BENCHMARK.json` on one CUDA device and prints one
JSON line. Everything a cell needs is found by name: its configuration in
`configs/`, its traffic mix in `traffic/`, its system adapter in
`systems/`, its plain reference in `reference/` and each per-layer metric's
reader in `metrics/`. Nothing here imports JAX or the JAX package.
"""
