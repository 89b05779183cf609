"""Kernel K1 (csrc/coverage.cu) bound to torch: chunk coverage on CUDA.

Replaces vgtpu/ops/coverage_pallas.py::_kernel_t2_rt.  The plain twin is
ops/coverage.py::coverage_chunks_torch; ops/coverage.py::cov_all routes CUDA
tensors here and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from vgtpu_torch.utils.cuda_build import CudaKernel, stream_ptr

MAX_CH = 32    # edges per chunk the kernel's shared staging holds

K1 = CudaKernel("coverage", "vg_coverage_chunks", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
])


def cov_all_cuda(chunk_edges: list, tile_h: int, tile_w: int) -> torch.Tensor:
    """(NC_total+1, NPX) coverage of every pool: one K1 launch per non-empty
    pool, each writing its own row range of one torch.empty tensor; the last
    (dead-chunk) row is zeroed, so no concat pass runs."""
    if not chunk_edges:
        raise ValueError("cov_all_cuda: no chunk pools")
    dev = chunk_edges[0].device
    npx = tile_h * tile_w
    for ce in chunk_edges:
        if ce.device != dev or not ce.is_cuda:
            raise ValueError(f"cov_all_cuda: pools must share one CUDA device, "
                             f"got {ce.device} and {dev}")
        if ce.dtype != torch.float32 or ce.dim() != 3 or ce.shape[2] != 4:
            raise ValueError(f"cov_all_cuda: pool must be (NC, CH, 4) float32, "
                             f"got {tuple(ce.shape)} {ce.dtype}")
        if not ce.is_contiguous():
            raise ValueError("cov_all_cuda: pool must be contiguous")
        if not 1 <= ce.shape[1] <= MAX_CH:
            raise ValueError(f"cov_all_cuda: CH={ce.shape[1]} outside 1..{MAX_CH}")
    total = sum(int(ce.shape[0]) for ce in chunk_edges)
    out = torch.empty((total + 1, npx), dtype=torch.float32, device=dev)
    out[total].zero_()
    row = 0
    with torch.cuda.device(dev):
        stream = stream_ptr(dev)
        for ce in chunk_edges:
            nc, ch = int(ce.shape[0]), int(ce.shape[1])
            if nc:
                K1.launch(ctypes.c_void_p(ce.data_ptr()),
                          ctypes.c_void_p(out.data_ptr() + row * npx * 4),
                          nc, ch, tile_w, npx, stream)
            row += nc
    return out
