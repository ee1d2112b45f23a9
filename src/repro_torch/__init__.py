"""PyTorch/CUDA port of the iMARS reproduction, for NVIDIA Hopper (sm_90a).

A second package beside the JAX reference (`repro`). It serves the
YoutubeDNN engine end to end (`serving.recsys_engine.RecSysEngine.build`
-> `serve` / `filter_stage` / `rank_stage`), frozen or over a live
catalog (`serving.catalog.LiveCatalog`) or a tiered out-of-core one
(`serving.tiered.TieredCatalog`); trains YoutubeDNN and DLRM
(`models.recsys` losses, `optim.adamw`, `distributed.training`,
`distributed.fault_tolerance.TrainLoop`) and keeps a live catalog fresh
while it serves (`serving.online.OnlineTrainer`, checked by
`serving.shadow.ShadowHarness`); and serves and trains the dense LM
family (`serving.engine`: `prefill`, `decode_step`,
`LMServingEngine.generate`, with `launch.serve` its CLI;
`distributed.training.make_train_step` over the blocked attention's
custom backward, with `launch.train` its CLI). Every TPU kernel of the
reference has a CUDA C++ counterpart under `kernels/csrc` — dense
Hamming distances, the streaming fixed-radius NNS, the int8 embedding
pool, flash attention and the int8 matmul — built with `nvcc` at first
use (`kernels/build.py`) and bound with `ctypes`.

Entry points run on `cuda` unless the caller passes `device="cpu"`; a CPU
tensor goes to each kernel's plain PyTorch version (`kernels/ref.py`).
Importing the package builds nothing and imports neither `jax`, `repro`
nor `triton`.
"""
from repro_torch.utils import resolve_device

__all__ = ["resolve_device"]
