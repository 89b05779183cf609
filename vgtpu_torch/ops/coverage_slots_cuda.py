"""Kernel K6 (csrc/coverage_slots.cu) bound to torch: chunk-major chunk
coverage of one pool on CUDA, in K1's design (exact row culling, a warp per
(chunk, row, 128 columns), edge windows for deep chunks).

Replaces vgtpu/ops/coverage_pallas.py::_kernel (coverage_chunks_pallas).
The plain twin is ops/coverage.py::coverage_chunks_torch;
ops/coverage.py::coverage_chunks routes CUDA tensors here and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from vgtpu_torch.ops.coverage_cuda import (
    CHUNKS_PER_BLOCK,
    EDGE_WINDOW,
    THREADS,
    deep_geometry,
    edge_mask_bytes,
    window_rows,
)
from vgtpu_torch.utils.cuda_build import CudaKernel, check_chunk_edges, current_stream

_vp, _i = ctypes.c_void_p, ctypes.c_int
K6 = CudaKernel("coverage_slots", {"vg_coverage_slots": [
    _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _vp,
]})


def k6_geometry(tile_h: int, tile_w: int, ch: int) -> dict:
    """vg_coverage_slots's launch geometry for a pool of ch-edge chunks over
    tile_h x tile_w tiles, mirroring csrc/coverage_slots.cu.  Up to
    EDGE_WINDOW edges the shallow form: K1's (coverage_cuda.k1_geometry: 4
    chunks a block, windows of rows), with the block's raw edges (16 bytes
    an edge, staged by one bulk copy) and its mbarrier in its shared
    memory.  Deeper the deep form (coverage_cuda.deep_geometry: one chunk a
    block, edge windows).  Raises ValueError only for a tile width that is
    not a multiple of 128."""
    if tile_h < 1 or tile_w < 128 or tile_w % 128:
        raise ValueError(f"K6: tiles of {tile_h}x{tile_w} (need tile_h >= 1 "
                         f"and tile_w a multiple of 128)")
    if ch < 1:
        raise ValueError(f"K6: CH={ch}")
    if ch > EDGE_WINDOW:
        return deep_geometry(tile_h, tile_w, THREADS)
    raw = 4 * CHUNKS_PER_BLOCK * 4 * ch + 16
    win = window_rows(ch, tile_h, 4 * CHUNKS_PER_BLOCK * (-(-ch // 32)),
                      edge_mask_bytes(ch, 0) + raw)
    smem = edge_mask_bytes(ch, win) + raw
    return {"form": "shallow", "threads": THREADS,
            "chunks_per_block": CHUNKS_PER_BLOCK, "edge_window": 0,
            "window_rows": win, "windows": -(-tile_h // win),
            "smem_bytes": smem, "shared_bytes": smem}


def coverage_chunks_slots_cuda(chunk_edges: torch.Tensor, tile_h: int,
                               tile_w: int) -> torch.Tensor:
    """(NC, CH, 4) edges -> (NC, TH, TW) coverage: one K6 launch on the
    edges' own device and its current stream."""
    ce = chunk_edges
    nc, ch = check_chunk_edges("coverage_chunks_slots_cuda", ce)
    geo = k6_geometry(tile_h, tile_w, ch)
    out = torch.empty((nc, tile_h, tile_w), dtype=torch.float32, device=ce.device)
    if nc:
        index = ce.get_device()
        K6.launch("vg_coverage_slots", ce.data_ptr(), out.data_ptr(), nc, ch,
                  tile_h, tile_w, geo["window_rows"], geo["edge_window"],
                  geo["smem_bytes"], index, current_stream(index))
    return out
