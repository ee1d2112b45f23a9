"""Build the CUDA kernels with `nvcc` at first use and bind them with ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so <name>.cu

The file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the library already built. The output
directory is `build/repro_torch` at the root of the checkout, or
`$REPRO_TORCH_BUILD_DIR`. `build_all` starts one `nvcc` per source, all at
once. Nothing here runs when the module is imported.

Every pointer and the stream pass as `ctypes.c_void_p`; each C entry point
returns `cudaGetLastError()` after its launches, and `CudaKernel.launch`
raises on a nonzero code. The launch counter of a kernel counts successful
launches through `launch` and nothing else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME)")
    return found


class _Job(NamedTuple):
    """One running `nvcc`: it writes `tmp`, renamed to `out` on success."""
    proc: subprocess.Popen
    tmp: str
    out: Path
    cmd: list


class CudaKernel:
    """One CUDA source, its shared library and its C entry point."""

    def __init__(self, name: str, source: str, argtypes: list):
        self.name = name
        self.source = CSRC / source
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in [self.source, *sorted(CSRC.glob("*.cuh"))]:
            h.update(path.name.encode())
            h.update(path.read_bytes())
        return h.hexdigest()[:16]

    def library_path(self) -> Path:
        return build_dir() / f"{self.source.stem}-{self.digest()}.so"

    def _compile(self) -> _Job | None:
        """Start `nvcc` for this source unless its library exists."""
        out = self.library_path()
        if out.exists():
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return _Job(proc, tmp, out, cmd)

    def _load(self):
        lib = ctypes.CDLL(str(self.library_path()))
        fn = getattr(lib, self.name)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.repro_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def launch(self, *args) -> None:
        """Call the C entry point (which launches on the given stream)."""
        if self._fn is None:
            build_all([self])
        code = self._fn(*args)
        if code != 0:
            raise RuntimeError(f"repro_torch kernel {self.name}: CUDA error "
                               f"{code} ({self._err(code).decode()})")
        self.launches += 1


def check_tensor(op: str, t, name: str, dtype, device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor on `device` (the CPU
    or a CUDA device with its index). Passing costs attribute reads only:
    a serve stage checks a dozen tensors a batch."""
    index = -1 if device.type == "cpu" else device.index
    if (t.dtype is not dtype or t.get_device() != index
            or not t.is_contiguous()):
        raise ValueError(
            f"{op}: {name} must be a contiguous {dtype} tensor on {device}, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def _finish(job: _Job) -> None:
    log, _ = job.proc.communicate()
    if job.proc.returncode != 0:
        os.unlink(job.tmp)
        raise RuntimeError(f"nvcc failed ({job.proc.returncode}): "
                           f"{' '.join(job.cmd)}\n{log}")
    os.replace(job.tmp, job.out)


def build_all(kernels=None) -> None:
    """Compile every kernel whose library is missing, in parallel, and
    load them all."""
    kernels = KERNELS if kernels is None else kernels
    jobs = [j for j in (k._compile() for k in kernels) if j is not None]
    try:
        for j in jobs:
            _finish(j)
    finally:
        for j in jobs:  # a failed build leaves no compiler running
            if j.proc.poll() is None:
                j.proc.kill()
                j.proc.wait()
    for k in kernels:
        if k._fn is None:
            k._load()


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


HAMMING = CudaKernel("hamming_distances", "hamming.cu",
                     [P, P, P, I, I, I, I, P])
EMBEDDING_POOL = CudaKernel("embedding_pool", "embedding_pool.cu",
                            [P, P, I, P, P, P])
STREAMING_NNS = CudaKernel("streaming_nns", "streaming_nns.cu",
                           [P, P, P, P, I, I, I, I, I, I, I, I, I, I,
                            P, P, P, P, P, P, P])
FLASH_ATTENTION = CudaKernel("flash_attention", "flash_attention.cu",
                             [P, P, P, P, I, I, I, I, I, F, I, I, P])
INT8_MATMUL = CudaKernel("int8_matmul", "int8_matmul.cu",
                         [P, P, P, P, P, I, I, I, P])
KERNELS = (HAMMING, EMBEDDING_POOL, STREAMING_NNS, FLASH_ATTENTION,
           INT8_MATMUL)
