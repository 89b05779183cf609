"""Build and bind the port's hand-written CUDA kernels (vgtpu_torch/csrc).

Each csrc/<name>.cu exports plain C entry points.  At first use it is
compiled with nvcc for Hopper (sm_90a) into build/cuda/ (gitignored), named
by a hash of its sources so an edited kernel rebuilds, and loaded with
ctypes.  Nothing here runs at import time: the CPU-only test environment has
no nvcc and never reaches a build.

A CudaKernel wraps a file's one entry point.  Every entry point returns
cudaGetLastError() after its launch; a non-zero code raises here.  The
kernel's `launches` counter is incremented only by the wrapper that launches
it (ops/*_cuda.py), so a run can show its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_CSRC = os.path.join(os.path.dirname(__file__), "..", "csrc")
_BUILD = os.path.join(os.path.dirname(__file__), "..", "..", "build", "cuda")

# -fmad=false: no implicit FMA contraction; the kernels write the FMAs their
# plain twins also take explicitly (see csrc/coverage.cu)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v")


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, else PATH, else the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


class CudaKernel:
    """The one exported entry point of csrc/<name>.cu: built into its own
    shared library on first use, called through ctypes, launches counted."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_seconds = None   # wall time of this process's build
        self.build_log = ""         # nvcc/ptxas output (registers, spills)
        self._lib = None
        self._fn = None

    def _sources(self) -> list[str]:
        src = os.path.join(_CSRC, f"{self.name}.cu")
        headers = sorted(
            os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
            if f.endswith(".cuh"))
        return [src] + headers

    def path(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in self._sources():
            with open(f, "rb") as fh:
                h.update(fh.read())
        return os.path.join(os.path.abspath(_BUILD),
                            f"lib{self.name}-{h.hexdigest()[:16]}.so")

    def build(self) -> float:
        """Compile (if needed), load and bind; returns this process's build
        seconds (0 when the library was already built)."""
        if self._fn is not None:
            return self.build_seconds
        out = self.path()
        self.build_seconds = 0.0
        if not os.path.exists(out):
            os.makedirs(os.path.dirname(out), exist_ok=True)
            tmp = f"{out}.tmp.{os.getpid()}"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                   os.path.abspath(os.path.join(_CSRC, f"{self.name}.cu"))]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_seconds = time.perf_counter() - t0
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for csrc/{self.name}.cu "
                    f"(rc={proc.returncode}):\n{self.build_log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        lib.vg_error_string.restype = ctypes.c_char_p
        lib.vg_error_string.argtypes = [ctypes.c_int]
        fn = getattr(lib, self.symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = self.argtypes
        self._lib, self._fn = lib, fn
        return self.build_seconds

    def launch(self, *args) -> None:
        """Call the entry point; raise on a non-zero cudaGetLastError()."""
        self.build()
        rc = self._fn(*args)
        if rc != 0:
            msg = self._lib.vg_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        self.launches += 1


def stream_ptr(device) -> ctypes.c_void_p:
    """The current torch CUDA stream of `device` as a ctypes pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
