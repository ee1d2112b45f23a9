#!/usr/bin/env python3
"""Where the port's streaming NNS kernel spends its time, on one GPU.

    python3 tools/streaming_nns_profile.py [--seed 0]

1. Builds `src/repro_torch/kernels/csrc/streaming_nns.cu` and variants of
   it that each cut one part out of pass 1 (their outputs are wrong on
   purpose; only their times are read):
   - `no_append`: candidates are never appended to the top-K stage;
   - `fast_only`: every 16-row group stops after the product and the AND
     of its accumulators (no count, no candidates).
   Each runs at phase B's shape, on LSH signatures of random 32-d
   embeddings (256 queries x 1,048,576 rows of 8 words, K = 50), at radius
   96 (about 3% of pairs match, as in `chip_smoke.py`'s phase B) and at
   radius -1 (nothing matches). It prints the CUDA-event time of a call
   and, from `torch.profiler`, the device time of each launch (memset,
   pass 0, bound, pass 1, merge). The full kernel's outputs are checked
   against the plain version.
2. Times `mma.sync.m16n8k32` s8 alone (`csrc/mma.cuh`) over warps per
   block and independent accumulator chains: the ceiling of the
   instruction the kernel is built on, in TOP/s.

Prints the card's name and power limit first. Needs nvcc and a GPU.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, ops, ref  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
INT8_PEAK_TOPS = 1979.0
VARIANTS = {
    "no_append": ("if (key < thr_key[slot]) h[k + atomicAdd(&staged[slot], "
                  "1)] = key;", ""),
    "fast_only": ("if (!__any_sync(repro::kFullMask, all >= 0)) continue;",
                  "if (all != 0x12345678) continue;"),
}
MMA_BENCH = r"""
#include <cstdio>
#include "mma.cuh"
template <int C>
__global__ void chains(int* out, int iters) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  uint32_t b0 = threadIdx.x * 5u, b1 = 11u;
  int acc[C][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < C; ++c) repro::mma_s8_16832(acc[c], a, b0, b1);
  }
  int s = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  if (s == 123456789) out[0] = s;
}
template <int C>
void run(int sms, int warps, int blocks_per_sm) {
  int* out;
  cudaMalloc(&out, 4);
  const int iters = 4096, grid = sms * blocks_per_sm;
  chains<C><<<grid, warps * 32>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  chains<C><<<grid, warps * 32>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double ops = double(grid) * warps * iters * C * 16 * 8 * 32 * 2;
  printf("mma.sync s8: %d warps/SM, %2d chains/warp: %.0f TOP/s\n",
         warps * blocks_per_sm, C, ops / (ms * 1e-3) / 1e12);
  cudaFree(out);
}
int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  run<1>(sms, 4, 2); run<4>(sms, 4, 2); run<8>(sms, 4, 2);
  run<16>(sms, 8, 2); run<16>(sms, 16, 2);
  return cudaGetLastError() != cudaSuccess;
}
"""


def lsh_sigs(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Sign bits of x @ proj packed into int32 words (bit i of word w is
    projection 32 w + i)."""
    bits = (x @ proj > 0).to(torch.int64).reshape(x.shape[0], -1, 32)
    w = (bits << torch.arange(32, device=x.device)).sum(-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def timed_ms(fn, reps: int = 20) -> float:
    """Mean device time of `fn` over back-to-back runs behind a spin."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def launch_ms(fn) -> list:
    """(kernel, device ms) of each launch of one call of `fn`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)", ev.name)
            out.append((m.group(1) if m else "memset",
                        round(ev.time_range.elapsed_us() / 1e3, 4)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("streaming_nns_profile: no GPU", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    proj = torch.randn((32, 256), generator=gen, device=dev)
    db = lsh_sigs(torch.randn((1 << 20, 32), generator=gen, device=dev), proj)
    qs = lsh_sigs(torch.randn((256, 32), generator=gen, device=dev), proj)

    out_dir = build.build_dir() / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    source = (CSRC / "streaming_nns.cu").read_text()
    kernels = {"kernel": build.STREAMING_NNS}
    for name, (old, new) in VARIANTS.items():
        if old not in source:
            raise SystemExit(f"variant {name}: pattern not in the source")
        path = out_dir / f"streaming_nns_{name}.cu"
        path.write_text(source.replace(old, new))
        kernels[name] = build.CudaKernel("streaming_nns", str(path),
                                         build.STREAMING_NNS.argtypes)
    build.build_all(list(kernels.values()))

    for radius in (96, -1):
        kw = dict(radius=radius, max_candidates=50)
        want = ref.streaming_nns_ref(qs, db, radius, 50)
        for name, kern in kernels.items():
            build.STREAMING_NNS = kern
            call = lambda: ops.streaming_nns_cuda(qs, db, **kw)  # noqa: E731
            got = call()
            note = ""
            if name == "kernel":
                equal = all(torch.equal(g, w) for g, w in zip(got, want))
                if not equal:
                    raise SystemExit("streaming_nns_profile: kernel != plain")
                note = (f", equal to the plain version, "
                        f"{float(got[2].float().mean()):.1f} matches a query")
            print(f"radius {radius:3d} {name:9s}: {timed_ms(call):.4f} ms; "
                  f"launches {launch_ms(call)}{note}", flush=True)
    build.STREAMING_NNS = kernels["kernel"]

    exe = out_dir / "mma_s8_bench"
    (out_dir / "mma_s8_bench.cu").write_text(MMA_BENCH)
    subprocess.run([build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-o", str(exe), str(out_dir / "mma_s8_bench.cu")],
                   check=True)
    res = subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True)
    for line in res.stdout.splitlines():
        tops = float(line.rsplit(":", 1)[1].split()[0])
        print(f"{line} ({100 * tops / INT8_PEAK_TOPS:.1f}% of "
              f"{INT8_PEAK_TOPS:.0f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
