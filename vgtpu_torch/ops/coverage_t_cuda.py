"""Kernel K4 (csrc/coverage_t.cu) bound to torch: pixel-major chunk coverage
on CUDA.

Replaces vgtpu/ops/coverage_pallas.py::_kernel_t2 (coverage_chunks_pallas_t_raw,
variant "row").  The plain twin is ops/coverage.py::coverage_chunks_t_torch;
ops/coverage.py::coverage_chunks_t and coverage_pools_t route CUDA tensors
here and nowhere else.  One launch covers every pool of a call (up to
coverage_cuda.MAX_POOLS a launch, packed by coverage_cuda.pack_pools), each
pool writing its own (NPX, NC) output.
"""

from __future__ import annotations

import array
import ctypes
import functools

import torch

from vgtpu_torch.ops.coverage_cuda import (
    EDGE_SCALARS,
    EDGE_WINDOW,
    deep_geometry,
    pack_pools,
)
from vgtpu_torch.utils.cuda_build import (
    SMEM_LIMIT,
    CudaKernel,
    check_chunk_edges,
    current_stream,
)

# csrc/coverage_t.cu's block: the one mirror of its constants
THREADS = 256          # kThreads: 8 warps, each with its transpose buffer
GROUP_COLS = 128       # kGroupCols: a warp's columns, 4 a lane
MAX_CHUNKS = 8         # kMaxChunks: chunks per block at most
ROWS_PER_BLOCK = 8     # kRowsPerBlock: rows a window holds at most

K4 = CudaKernel("coverage_t", {"vg_coverage_chunks_t": [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]})


def k4_smem(ch: int, cpb: int, rows: int) -> int:
    """Dynamic shared bytes of a shallow K4 block over cpb chunks of ch
    edges and a window of `rows` rows: the edge scalars (8 floats an edge),
    the row masks (ceil(ch/32) words a row) and each warp's transpose
    buffer (GROUP_COLS pixels x (cpb + 1) floats)."""
    return 4 * (cpb * (EDGE_SCALARS * ch + rows * (-(-ch // 32)))
                + THREADS // 32 * GROUP_COLS * (cpb + 1))


def k4_geometry(tile_h: int, tile_w: int, ch: int) -> dict:
    """vg_coverage_chunks_t's launch geometry for a pool of ch-edge chunks
    over tile_h x tile_w tiles, mirroring csrc/coverage_t.cu.  Up to
    coverage_cuda.EDGE_WINDOW edges the shallow form: blocks of 256
    threads over cpb chunks and a window of rows, a warp per (row, 128
    columns); cpb is the largest of 8, 4, 2, 1 whose staging holds one row
    (8 throughout the shallow range), the window the most rows up to
    ROWS_PER_BLOCK (and tile_h) that fit SMEM_LIMIT; blocks along grid.y
    (at most 65,535) stride over the tile's windows.  Deeper chunks take
    the deep form (coverage_cuda.deep_geometry: one chunk a block, edge
    windows, no transpose).  A launch over several pools takes its deepest
    pool's geometry.  Raises ValueError only for a tile width that is not a
    multiple of 128."""
    if tile_h < 1 or tile_w < 128 or tile_w % 128:
        raise ValueError(f"K4: tiles of {tile_h}x{tile_w} (need tile_h >= 1 "
                         f"and tile_w a multiple of 128)")
    if ch < 1:
        raise ValueError(f"K4: CH={ch}")
    if ch > EDGE_WINDOW:
        return deep_geometry(tile_h, tile_w, THREADS)
    cpb = MAX_CHUNKS
    while cpb > 1 and k4_smem(ch, cpb, 1) > SMEM_LIMIT:
        cpb //= 2
    rows = min(tile_h, ROWS_PER_BLOCK)
    while k4_smem(ch, cpb, rows) > SMEM_LIMIT:
        rows -= 1
    smem = k4_smem(ch, cpb, rows)
    return {"form": "shallow", "threads": THREADS, "chunks_per_block": cpb,
            "edge_window": 0, "window_rows": rows,
            "grid_y": min(-(-tile_h // rows), 65535), "smem_bytes": smem,
            "shared_bytes": smem}


_packed = functools.lru_cache(maxsize=256)(pack_pools)   # keyed by shapes, cpb


def coverage_pools_t_cuda(chunk_edges: list, tile_h: int,
                          tile_w: int) -> list:
    """[(NC_i, CH_i, 4) edges] -> [(TH*TW, NC_i) pixel-major coverage]: one
    K4 launch over every pool (one per MAX_POOLS pools), on the pools' own
    device and its current stream; an empty pool gets an empty output and
    no descriptor."""
    fn = "coverage_pools_t_cuda"
    if not chunk_edges:
        raise ValueError(f"{fn}: no chunk pools")
    shapes, max_ch = [], 0
    for ce in chunk_edges:
        nc, ch = check_chunk_edges(fn, ce)
        if ce.get_device() != chunk_edges[0].get_device():
            raise ValueError(f"{fn}: pools must share one CUDA device, got "
                             f"{ce.device} and {chunk_edges[0].device}")
        shapes.append((nc, ch))
        max_ch = max(max_ch, ch)
    geo = k4_geometry(tile_h, tile_w, max_ch)
    npx = tile_h * tile_w
    dev = chunk_edges[0].device
    outs = [torch.empty((npx, nc), dtype=torch.float32, device=dev)
            for nc, _ch in shapes]
    index = chunk_edges[0].get_device()
    stream = current_stream(index)
    cpb = geo["chunks_per_block"]
    for descs in _packed(tuple(shapes), cpb):
        words = []   # csrc/edge_coverage.cuh kDescWords per pool
        for i, _row, block0 in descs:
            words += (chunk_edges[i].data_ptr(), 0, outs[i].data_ptr(),
                      shapes[i][0], shapes[i][1], block0)
        desc = array.array("q", words)
        K4.launch("vg_coverage_chunks_t", desc.buffer_info()[0], len(descs),
                  tile_h, tile_w, cpb, geo["window_rows"], geo["edge_window"],
                  geo["smem_bytes"], index, stream)
    return outs


def coverage_chunks_t_cuda(chunk_edges: torch.Tensor, tile_h: int,
                           tile_w: int) -> torch.Tensor:
    """(NC, CH, 4) edges -> (TH*TW, NC) pixel-major coverage: one K4 launch
    (coverage_pools_t_cuda over one pool)."""
    return coverage_pools_t_cuda([chunk_edges], tile_h, tile_w)[0]

