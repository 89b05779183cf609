"""Kernel K4 (csrc/coverage_t.cu) bound to torch: pixel-major chunk coverage
on CUDA.

Replaces vgtpu/ops/coverage_pallas.py::_kernel_t2 (coverage_chunks_pallas_t_raw,
variant "row").  The plain twin is ops/coverage.py::coverage_chunks_t_torch;
ops/coverage.py::coverage_chunks_t routes CUDA tensors here and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from vgtpu_torch.utils.cuda_build import (
    SMEM_LIMIT,
    CudaKernel,
    check_chunk_edges,
    current_stream,
)

_EDGE_BYTES = 8 * 32 * 4   # one edge's scalars for the block's 32 chunks

K4 = CudaKernel("coverage_t", {"vg_coverage_chunks_t": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]})


def k4_geometry(ch: int) -> dict:
    """vg_coverage_chunks_t's staging for chunks of ch edges, mirroring
    csrc/coverage_t.cu: 32 x 8 threads over 32 chunks; each edge's 8
    scalars for the 32 chunks (1 KB an edge) in dynamic shared memory sized
    at launch (smem_bytes).  Raises ValueError for a CH the card cannot hold
    (over SMEM_LIMIT shared bytes per block)."""
    if ch < 1:
        raise ValueError(f"K4: CH={ch}")
    smem = ch * _EDGE_BYTES
    if smem > SMEM_LIMIT:
        raise ValueError(f"K4: CH={ch} needs {smem} shared bytes per block, "
                         f"over the card's {SMEM_LIMIT}")
    return {"threads": 256, "chunks_per_block": 32, "smem_bytes": smem,
            "shared_bytes": smem}


def coverage_chunks_t_cuda(chunk_edges: torch.Tensor, tile_h: int,
                           tile_w: int) -> torch.Tensor:
    """(NC, CH, 4) edges -> (TH*TW, NC) pixel-major coverage: one K4 launch
    on the edges' own device and its current stream."""
    ce = chunk_edges
    nc, ch = check_chunk_edges("coverage_chunks_t_cuda", ce)
    smem = k4_geometry(ch)["smem_bytes"]
    npx = tile_h * tile_w
    dev = ce.device
    out = torch.empty((npx, nc), dtype=torch.float32, device=dev)
    if nc:
        index = ce.get_device()
        K4.launch("vg_coverage_chunks_t", ce.data_ptr(), out.data_ptr(), nc,
                  ch, tile_w, npx, smem, index, current_stream(index))
    return out
