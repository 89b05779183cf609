"""Build and bind the port's hand-written CUDA kernels (vgtpu_torch/csrc).

Each csrc/<name>.cu exports plain C entry points.  At first use it is
compiled with nvcc for Hopper (sm_90a) into build/cuda/ (gitignored), named
by a hash of its sources so an edited kernel rebuilds, and loaded with
ctypes.  Nothing here runs at import time: the CPU-only test environment has
no nvcc and never reaches a build.

A CudaKernel wraps a file's entry points (most files export one).  Every
entry point returns cudaGetLastError() after its launch; a non-zero code
raises here.  The kernel's `launches` counter is incremented only by the
wrappers that launch it (ops/*_cuda.py), so a run can show its main path
went through the kernel.  check_tensor and check_chunk_edges are the
wrappers' shared argument checks.

The launch route, per wrapper call, is kept as cheap as one PyTorch op's:
the entry points are bound once (ctypes argtypes, so pointers, the stream
and ints pass as plain Python ints); the stream is the raw cudaStream_t of
the tensors' device (current_stream, no torch.cuda.Stream object); the
device goes to the entry point as an index (csrc/common.cuh::DeviceScope
switches only when the calling thread's current device is another), so no
torch.cuda.device context is entered; and the checks compare shapes and
device indices without building tuples or torch.device objects.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_CSRC = os.path.join(os.path.dirname(__file__), "..", "csrc")
_BUILD = os.path.join(os.path.dirname(__file__), "..", "..", "build", "cuda")

# -fmad=false: no implicit FMA contraction; the kernels write the FMAs their
# plain twins also take explicitly (see csrc/coverage.cu)
SMEM_LIMIT = 232_448   # shared bytes a block may use on an H100 (227 KB)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v")


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, else PATH, else the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


class CudaKernel:
    """The exported entry points of csrc/<name>.cu: built into one shared
    library on first use, called through ctypes, launches counted.
    entries maps each C symbol to its ctypes argtypes."""

    def __init__(self, name: str, entries: dict):
        self.name = name
        self.entries = dict(entries)
        self.launches = 0
        self.build_seconds = None   # wall time of this process's build
        self.build_log = ""         # nvcc/ptxas output (registers, spills)
        self._lib = None
        self._fns = None

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
        if self._fns is not None:
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
        fns = {}
        for symbol, argtypes in self.entries.items():
            fn = getattr(lib, symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
            fns[symbol] = fn
        self._lib, self._fns = lib, fns
        return self.build_seconds

    def launch(self, symbol: str, *args) -> None:
        """Call entry point `symbol` (built and bound at first use); raise
        on a non-zero cudaGetLastError().  Pointers and the stream are
        Python ints."""
        fns = self._fns
        if fns is None:
            self.build()
            fns = self._fns
        rc = fns[symbol](*args)
        if rc:
            msg = self._lib.vg_error_string(rc).decode()
            raise RuntimeError(f"{symbol}: CUDA error {rc} ({msg})")
        self.launches += 1


def current_stream(index: int) -> int:
    """The raw cudaStream_t of torch's current stream on CUDA device
    `index`, as an int (the accessor PyTorch's own generated kernels use)."""
    return torch._C._cuda_getCurrentRawStream(index)


def check_tensor(who: str, name: str, t, dtype, shape: tuple, index: int,
                 align: int = 0) -> None:
    """Raise ValueError unless t is a contiguous `dtype` tensor of `shape`
    on CUDA device `index` (a tensor's get_device(): -1 on the CPU), its
    data `align`-byte aligned when align > 0 (who: the calling wrapper,
    name: the argument)."""
    if (t is not None and t.get_device() == index and t.dtype == dtype
            and t.shape == shape and t.is_contiguous()
            and not (align and t.data_ptr() % align)):
        return
    if t is None:
        raise ValueError(f"{who}: {name} missing")
    if t.get_device() != index:
        raise ValueError(f"{who}: {name} on {t.device}, expected cuda:{index}")
    if t.dtype != dtype or t.shape != shape:
        raise ValueError(f"{who}: {name} must be {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")
    raise ValueError(f"{who}: {name} must be {align}-byte aligned")


def check_chunk_edges(who: str, ce) -> tuple[int, int]:
    """(NC, CH) of the chunk edges a coverage kernel (K4, K5, K6) takes:
    (NC, CH, 4) float32 on a CUDA device, contiguous and 16-byte aligned
    (K5 and K6 load each edge as one float4), CH >= 1; raises ValueError
    otherwise."""
    if not ce.is_cuda:
        raise ValueError(f"{who}: edges on {ce.device}, not a CUDA device")
    if ce.dtype != torch.float32 or ce.dim() != 3 or ce.shape[2] != 4:
        raise ValueError(f"{who}: edges must be (NC, CH, 4) float32, got "
                         f"{tuple(ce.shape)} {ce.dtype}")
    if not ce.is_contiguous() or ce.data_ptr() % 16:
        raise ValueError(f"{who}: edges must be contiguous and 16-byte aligned")
    nc, ch = int(ce.shape[0]), int(ce.shape[1])
    if ch < 1:
        raise ValueError(f"{who}: CH={ch}")
    return nc, ch
