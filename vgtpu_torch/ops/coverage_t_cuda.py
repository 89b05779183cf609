"""Kernel K4 (csrc/coverage_t.cu) bound to torch: pixel-major chunk coverage
on CUDA.

Replaces vgtpu/ops/coverage_pallas.py::_kernel_t2 (coverage_chunks_pallas_t_raw,
variant "row").  The plain twin is ops/coverage.py::coverage_chunks_t_torch;
ops/coverage.py::coverage_chunks_t routes CUDA tensors here and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from vgtpu_torch.utils.cuda_build import CudaKernel, check_chunk_edges, current_stream

MAX_CH = 32    # edges per chunk the kernel's shared staging holds

K4 = CudaKernel("coverage_t", {"vg_coverage_chunks_t": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]})


def coverage_chunks_t_cuda(chunk_edges: torch.Tensor, tile_h: int,
                           tile_w: int) -> torch.Tensor:
    """(NC, CH, 4) edges -> (TH*TW, NC) pixel-major coverage: one K4 launch
    on the edges' own device and its current stream."""
    ce = chunk_edges
    nc, ch = check_chunk_edges("coverage_chunks_t_cuda", ce, MAX_CH)
    npx = tile_h * tile_w
    dev = ce.device
    out = torch.empty((npx, nc), dtype=torch.float32, device=dev)
    if nc:
        index = ce.get_device()
        K4.launch("vg_coverage_chunks_t", ce.data_ptr(), out.data_ptr(), nc,
                  ch, tile_w, npx, index, current_stream(index))
    return out
