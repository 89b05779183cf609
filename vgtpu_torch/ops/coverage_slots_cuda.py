"""Kernel K6 (csrc/coverage_slots.cu) bound to torch: chunk-major chunk
coverage on CUDA, one thread per (chunk, pixel).

Replaces vgtpu/ops/coverage_pallas.py::_kernel (coverage_chunks_pallas).
The plain twin is ops/coverage.py::coverage_chunks_torch;
ops/coverage.py::coverage_chunks routes CUDA tensors here and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from vgtpu_torch.utils.cuda_build import CudaKernel, check_chunk_edges, current_stream

K6 = CudaKernel("coverage_slots", {"vg_coverage_slots": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]})


def coverage_chunks_slots_cuda(chunk_edges: torch.Tensor, tile_h: int,
                               tile_w: int) -> torch.Tensor:
    """(NC, CH, 4) edges -> (NC, TH, TW) coverage: one K6 launch on the
    edges' own device and its current stream."""
    ce = chunk_edges
    nc, ch = check_chunk_edges("coverage_chunks_slots_cuda", ce)
    dev = ce.device
    out = torch.empty((nc, tile_h, tile_w), dtype=torch.float32, device=dev)
    if nc:
        index = ce.get_device()
        K6.launch("vg_coverage_slots", ce.data_ptr(), out.data_ptr(), nc, ch,
                  tile_w, tile_h * tile_w, index, current_stream(index))
    return out
