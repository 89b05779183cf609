"""Kernel K5 (csrc/coverage_t_flat.cu) bound to torch: pixel-major chunk
coverage on CUDA in the flat form.

Replaces vgtpu/ops/coverage_pallas.py::_kernel_t (coverage_chunks_pallas_t_raw,
variant "flat").  The plain twin is ops/coverage.py::coverage_chunks_t_torch;
ops/coverage.py::coverage_chunks_t(variant="flat") routes CUDA tensors here
and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from vgtpu_torch.utils.cuda_build import CudaKernel, check_chunk_edges, current_stream

K5 = CudaKernel("coverage_t_flat", {"vg_coverage_t_flat": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]})


def coverage_chunks_t_flat_cuda(chunk_edges: torch.Tensor, tile_h: int,
                                tile_w: int) -> torch.Tensor:
    """(NC, CH, 4) edges -> (TH*TW, NC) pixel-major coverage: one K5 launch
    on the edges' own device and its current stream."""
    ce = chunk_edges
    nc, ch = check_chunk_edges("coverage_chunks_t_flat_cuda", ce)
    npx = tile_h * tile_w
    dev = ce.device
    out = torch.empty((npx, nc), dtype=torch.float32, device=dev)
    if nc:
        index = ce.get_device()
        K5.launch("vg_coverage_t_flat", ce.data_ptr(), out.data_ptr(), nc, ch,
                  tile_w, npx, index, current_stream(index))
    return out
