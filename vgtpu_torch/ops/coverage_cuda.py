"""Kernel K1 (csrc/coverage.cu) bound to torch: chunk coverage on CUDA.

Replaces vgtpu/ops/coverage_pallas.py::_kernel_t2_rt.  The plain twin is
ops/coverage.py::coverage_chunks_torch; ops/coverage.py::cov_all routes CUDA
tensors here and nowhere else.  pack_pools lays out the pool descriptors of
K1's, K3's and K4's launches (csrc/edge_coverage.cuh vg::Pools); EDGE_WINDOW
and deep_smem size the deep form every coverage kernel takes for chunks
deeper than one edge window.  A view window (ops/coverage.ViewWindow)
restricts K1 to the chunks of the scene tiles a retained pan's view
reaches.
"""

from __future__ import annotations

import array
import ctypes
import functools

import torch

from vgtpu_torch.utils.cuda_build import (
    SMEM_LIMIT,
    CudaKernel,
    check_tensor,
    current_stream,
)

# K1's and K3's launch geometry: the one mirror of csrc/edge_coverage.cuh's
# constants, which both kernels take (coverage_resolve_cuda imports it).  A
# drift is refused on the card: read_pools rejects a block prefix counted
# with another CHUNKS_PER_BLOCK, the entry points a smem size below theirs.
MAX_POOLS = 8          # kMaxPools: pool descriptors a launch holds
CHUNKS_PER_BLOCK = 4   # kPoolChunksPerBlock
THREADS = 128          # kPoolThreads
EDGE_SCALARS = 8       # kEdgeScalars: floats an edge stages
# The coverage kernels' edge window (K1, K3-K6): a launch whose deepest
# chunk holds more edges takes the deep form (one chunk a block, its edges
# staged EDGE_WINDOW at a time, csrc/edge_coverage.cuh::walk_deep), so no
# CH is refused; shallower launches keep the shallow form, which stages a
# block's edges at once.  A multiple of 32 (whole mask words).
EDGE_WINDOW = 512

K1 = CudaKernel("coverage", {"vg_coverage_chunks": [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]})


def deep_smem(ew: int, rows: int) -> int:
    """Dynamic shared bytes of a deep-form block (csrc/edge_coverage.cuh
    vg::deep_smem): one window's per-edge scalars (8 floats an edge) and
    the masks of `rows` rows (ceil(ew/32) words a row)."""
    return 4 * EDGE_SCALARS * ew + 4 * rows * (-(-ew // 32))


def deep_geometry(tile_h: int, tile_w: int, threads: int) -> dict:
    """The deep form's launch geometry over tile_h x tile_w tiles for
    blocks of `threads` threads: one chunk a block, a warp per (row, 128
    columns) unit, a block's warps over consecutive units (at most one row
    each), blocks along grid.y (at most 65,535) striding over a tile's
    units; one window of EDGE_WINDOW edges staged at a time."""
    warps = threads // 32
    rows = min(tile_h, warps)
    smem = deep_smem(EDGE_WINDOW, rows)
    return {"form": "deep", "threads": threads, "chunks_per_block": 1,
            "edge_window": EDGE_WINDOW, "window_rows": rows,
            "grid_y": min(-(-tile_h * (tile_w // 128) // warps), 65535),
            "smem_bytes": smem, "shared_bytes": smem}


def edge_mask_bytes(ch: int, rows: int) -> int:
    """Dynamic shared bytes of a K1 or K3 block's edge staging for chunks of
    ch edges over a window of `rows` (sub-)rows: each chunk's per-edge
    scalars (8 floats an edge) and its row masks (ceil(ch/32) 32-bit words
    a row)."""
    return 4 * CHUNKS_PER_BLOCK * (EDGE_SCALARS * ch + rows * (-(-ch // 32)))


def window_rows(ch: int, tile_h: int, row_bytes: int, fixed_bytes: int,
                step: int = 1) -> int:
    """The rows of a staging window: all tile_h rows where the block's
    staging, fixed_bytes + row_bytes a row, fits the card's SMEM_LIMIT,
    else the most rows that fit, a multiple of `step` (K3's sub-rows come
    ss to an output row).  Raises ValueError when not even `step` rows fit:
    the CH is too deep for one block."""
    fit = (SMEM_LIMIT - fixed_bytes) // row_bytes // step * step
    if fit < step:
        raise ValueError(f"CH={ch}: {fixed_bytes} shared bytes of edges leave no "
                         f"room for {step} row(s) of masks within the card's "
                         f"{SMEM_LIMIT}")
    return min(tile_h, fit)


def k1_geometry(tile_h: int, tile_w: int, ch: int) -> dict:
    """vg_coverage_chunks's launch geometry for a pool of ch-edge chunks over
    tile_h x tile_w tiles, mirroring csrc/coverage.cu.  Up to EDGE_WINDOW
    edges the shallow form: blocks of 128 threads over 4 chunks, a warp per
    (chunk, row, 128-column group); the staging (edge_mask_bytes) in
    dynamic shared memory over a window of `window_rows` rows, the whole
    tile where it fits the card.  Deeper chunks take the deep form
    (deep_geometry: one chunk a block, edge windows).  A launch over
    several pools takes its deepest pool's geometry.  Raises ValueError
    only for a tile width that is not a multiple of 128 columns (vgtpu
    admits 128 and 256)."""
    if tile_h < 1 or tile_w < 128 or tile_w % 128:
        raise ValueError(f"K1: tiles of {tile_h}x{tile_w} (need tile_h >= 1 "
                         f"and tile_w a multiple of 128)")
    if ch < 0:
        raise ValueError(f"K1: CH={ch}")
    if ch > EDGE_WINDOW:
        return deep_geometry(tile_h, tile_w, THREADS)
    win = window_rows(ch, tile_h, 4 * CHUNKS_PER_BLOCK * (-(-ch // 32)),
                      edge_mask_bytes(ch, 0))
    smem = edge_mask_bytes(ch, win)
    return {"form": "shallow", "threads": THREADS,
            "chunks_per_block": CHUNKS_PER_BLOCK, "edge_window": 0,
            "window_rows": win, "windows": -(-tile_h // win),
            "smem_bytes": smem, "shared_bytes": smem}


def pack_pools(shapes: list, chunks_per_block: int = CHUNKS_PER_BLOCK) -> list:
    """The launches of one K1, K3 or K4 call over pools of shapes [(NC, CH,
    ...), ...] whose chunk rows follow one another in one output tensor (K4
    ignores the rows: each pool has its own).  Returns a list of launches,
    each a list of descriptors (pool index, first output row, first block),
    block0 running from 0 in each launch, ceil(NC / chunks_per_block)
    blocks a pool.  Empty pools get no descriptor.  The deepest pools
    (largest CH) come first, so their blocks, the longest, start first; a
    launch holds at most MAX_POOLS descriptors, and further pools take
    further launches."""
    rows, row = [], 0
    for shape in shapes:
        rows.append(row)
        row += shape[0]
    order = sorted((i for i, shape in enumerate(shapes) if shape[0] > 0),
                   key=lambda i: -shapes[i][1])
    launches = []
    for k in range(0, len(order), MAX_POOLS):
        descs, block = [], 0
        for i in order[k:k + MAX_POOLS]:
            descs.append((i, rows[i], block))
            block += -(-shapes[i][0] // chunks_per_block)
        launches.append(descs)
    return launches


_packed = functools.lru_cache(maxsize=256)(pack_pools)   # keyed by shapes, cpb


def launch_pools(kernel: CudaKernel, symbol: str, pools: list, rps, out:
                 torch.Tensor, row_floats: int, geo: dict, *args) -> None:
    """Launch `symbol` of `kernel` over pools (each (NC, CH, 4), or None for
    a chunk without edges), their rparams (K3) or chunk tiles (K1 under a
    view window; None, or None for a pool, otherwise) and their rows
    of `out` (row_floats floats a row), as pack_pools lays them out with
    geo's chunks per block: one launch per MAX_POOLS pools, each with geo's
    dynamic shared bytes (the deepest pool's).  The descriptors go to the
    entry point as a host array of 64-bit words; args follow their count,
    then geo's edge window, its shared bytes, the device and the stream."""
    shapes = tuple([(1, 0) if ce is None else ce.shape for ce in pools])
    index = out.get_device()
    stream = current_stream(index)
    base = out.data_ptr()
    row_bytes = row_floats * 4
    for descs in _packed(shapes, geo["chunks_per_block"]):
        words = []   # csrc/edge_coverage.cuh kDescWords per pool
        for i, row, block0 in descs:
            ce = pools[i]
            words += (0 if ce is None else ce.data_ptr(),
                      0 if rps is None or rps[i] is None else rps[i].data_ptr(),
                      base + row * row_bytes, shapes[i][0], shapes[i][1], block0)
        desc = array.array("q", words)
        kernel.launch(symbol, desc.buffer_info()[0], len(descs), *args,
                      geo["edge_window"], geo["smem_bytes"], index, stream)


def cov_all_cuda(chunk_edges: list, tile_h: int, tile_w: int, window=None,
                 chunk_tiles: list | None = None) -> torch.Tensor:
    """(NC_total+1, NPX) coverage of every pool in one K1 launch (one per
    MAX_POOLS pools), each pool writing its own row range of one torch.empty
    tensor; the last (dead-chunk) row is a pool of one chunk without edges,
    which K1 writes as zeros in the same launch.  With a view window
    (ops/coverage.ViewWindow) and chunk_tiles, each pool's (NC,) int32 scene
    tile ids, K1 computes and writes only the rows of chunks whose tile the
    window holds, and the dead row: the other rows stay unwritten."""
    if not chunk_edges:
        raise ValueError("cov_all_cuda: no chunk pools")
    if (window is None) != (chunk_tiles is None) or (
            chunk_tiles is not None and len(chunk_tiles) != len(chunk_edges)):
        raise ValueError("cov_all_cuda: a view window takes one chunk-tile "
                         "array a pool")
    dev = chunk_edges[0].device
    index = chunk_edges[0].get_device()
    total = max_ch = 0
    for ce in chunk_edges:
        if ce.get_device() != index or not ce.is_cuda:
            raise ValueError(f"cov_all_cuda: pools must share one CUDA device, "
                             f"got {ce.device} and {dev}")
        if ce.dtype != torch.float32 or ce.dim() != 3 or ce.shape[2] != 4:
            raise ValueError(f"cov_all_cuda: pool must be (NC, CH, 4) float32, "
                             f"got {tuple(ce.shape)} {ce.dtype}")
        if not ce.is_contiguous() or ce.data_ptr() % 16:
            raise ValueError("cov_all_cuda: pool must be contiguous and "
                             "16-byte aligned")
        if ce.shape[1] < 1:
            raise ValueError(f"cov_all_cuda: CH={ce.shape[1]}")
        total += ce.shape[0]
        max_ch = max(max_ch, ce.shape[1])
    view, tiles = None, None
    if window is not None:
        for ce, t in zip(chunk_edges, chunk_tiles):
            check_tensor("cov_all_cuda", "chunk_tiles", t, torch.int32,
                         (ce.shape[0],), index)
        # columns [x0, x1), rows [y0, y1) of a grid ntx tiles wide; read on
        # the host at the launch
        view = array.array("i", (*window.tiles, window.ntx))
        tiles = [*chunk_tiles, None]
    geo = k1_geometry(tile_h, tile_w, max_ch)
    npx = tile_h * tile_w
    out = torch.empty((total + 1, npx), dtype=torch.float32, device=dev)
    launch_pools(K1, "vg_coverage_chunks", [*chunk_edges, None], tiles, out, npx,
                 geo, tile_h, tile_w, geo["window_rows"],
                 None if view is None else view.buffer_info()[0])
    return out
