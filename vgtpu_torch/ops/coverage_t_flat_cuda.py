"""Kernel K5 (csrc/coverage_t_flat.cu) bound to torch: pixel-major chunk
coverage of one pool on CUDA, the entry point of vgtpu's flat variant, in
K4's design (exact row culling, 8 chunks a block, a warp-private transpose,
edge windows for deep chunks).

Replaces vgtpu/ops/coverage_pallas.py::_kernel_t (coverage_chunks_pallas_t_raw,
variant "flat").  The plain twin is ops/coverage.py::coverage_chunks_t_torch;
ops/coverage.py::coverage_chunks_t(variant="flat") routes CUDA tensors here
and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from vgtpu_torch.ops.coverage_t_cuda import k4_geometry
from vgtpu_torch.utils.cuda_build import CudaKernel, check_chunk_edges, current_stream

_vp, _i = ctypes.c_void_p, ctypes.c_int
K5 = CudaKernel("coverage_t_flat", {"vg_coverage_t_flat": [
    _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _vp,
]})


def k5_geometry(tile_h: int, tile_w: int, ch: int) -> dict:
    """vg_coverage_t_flat's launch geometry for a pool of ch-edge chunks
    over tile_h x tile_w tiles, mirroring csrc/coverage_t_flat.cu: K4's
    (coverage_t_cuda.k4_geometry), whose block layout K5 shares.  Up to
    coverage_cuda.EDGE_WINDOW edges the shallow form (cpb chunks a block,
    windows of at most 8 rows along grid.y), deeper the deep form (one
    chunk a block, edge windows).  Raises ValueError only for a tile width
    that is not a multiple of 128."""
    if tile_h < 1 or tile_w < 128 or tile_w % 128:
        raise ValueError(f"K5: tiles of {tile_h}x{tile_w} (need tile_h >= 1 "
                         f"and tile_w a multiple of 128)")
    if ch < 1:
        raise ValueError(f"K5: CH={ch}")
    return k4_geometry(tile_h, tile_w, ch)


def coverage_chunks_t_flat_cuda(chunk_edges: torch.Tensor, tile_h: int,
                                tile_w: int) -> torch.Tensor:
    """(NC, CH, 4) edges -> (TH*TW, NC) pixel-major coverage: one K5 launch
    on the edges' own device and its current stream."""
    ce = chunk_edges
    nc, ch = check_chunk_edges("coverage_chunks_t_flat_cuda", ce)
    geo = k5_geometry(tile_h, tile_w, ch)
    out = torch.empty((tile_h * tile_w, nc), dtype=torch.float32, device=ce.device)
    if nc:
        index = ce.get_device()
        K5.launch("vg_coverage_t_flat", ce.data_ptr(), out.data_ptr(), nc, ch,
                  tile_h, tile_w, geo["chunks_per_block"], geo["window_rows"],
                  geo["edge_window"], geo["smem_bytes"], index,
                  current_stream(index))
    return out
