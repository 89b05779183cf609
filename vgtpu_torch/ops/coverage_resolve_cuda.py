"""Kernel K3 (csrc/coverage_resolve.cu) bound to torch: resolved chunk
coverage for supersampled frames on CUDA.

Replaces vgtpu/ops/coverage_resolve.py::_kernel_t2_res.  Its plain twins are
ops/coverage_resolve.py::coverage_chunks_res_torch (vg_coverage_chunks_res)
and resolve_cov_rows_torch (vg_resolve_rows); ops/coverage_resolve.py::
cov_split_resolved routes CUDA tensors here and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from vgtpu_torch.ops.coverage_cuda import (
    CHUNKS_PER_BLOCK,
    EDGE_WINDOW,
    THREADS,
    deep_smem,
    edge_mask_bytes,
    launch_pools,
    window_rows,
)
from vgtpu_torch.ops.coverage_resolve import RP_BD, rp_rows
from vgtpu_torch.utils.cuda_build import (
    SMEM_LIMIT,
    CudaKernel,
    check_tensor,
    current_stream,
)

_STATIC_TH = 64        # csrc/coverage_resolve.cu kStaticTh

_vp = ctypes.c_void_p
_i = ctypes.c_int
K3 = CudaKernel("coverage_resolve", {
    "vg_coverage_chunks_res": [_vp, _i, _i, _i, _i, _i, _i, _i, _i, _vp],
    "vg_resolve_rows": [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _vp],
})


def k3_geometry(tile_h: int, ss: int, ch: int) -> dict:
    """vg_coverage_chunks_res's launch geometry for a pool of ch-edge chunks
    over tiles of tile_h sub-rows at ss, mirroring csrc/coverage_resolve.cu.
    Up to coverage_cuda.EDGE_WINDOW edges the shallow forms: 128 threads per
    block of 4 chunks; in dynamic shared memory each chunk's per-edge
    scalars and the sub-row masks of a window of `window_rows` sub-rows
    (coverage_cuda.edge_mask_bytes).  Tiles of up to 64 sub-rows take the
    static form: one window, each chunk's rparams column (RP_BD + 64 rows)
    in static shared memory.  Taller tiles take the windowed form: windows
    of whole output rows (a multiple of ss sub-rows), the whole tile where
    it fits the card, and RP_BD + the window's sub-rows of rparams after
    the masks in the dynamic shared memory (smem_bytes).  Deeper chunks take
    the deep form: one chunk a block, a warp per (output row, 128 columns),
    its sub-rows walked one after another over windows of EDGE_WINDOW edges
    (one window's scalars and 4 sub-rows' masks; the rparams read from
    device memory).  A launch over several pools takes its deepest pool's
    geometry.  Raises ValueError only for ss not dividing tile_h."""
    if ss < 1 or tile_h < ss or tile_h % ss:
        raise ValueError(f"K3: tile_h={tile_h} sub-rows with ss={ss} "
                         f"(need ss | tile_h)")
    if ch < 0:
        raise ValueError(f"K3: CH={ch}")
    if ch > EDGE_WINDOW:
        smem = deep_smem(EDGE_WINDOW, THREADS // 32)
        return {"form": "deep", "threads": THREADS, "chunks_per_block": 1,
                "edge_window": EDGE_WINDOW, "window_rows": tile_h,
                "windows": 1, "staged_rows": 0, "smem_bytes": smem,
                "shared_bytes": smem}
    static = tile_h <= _STATIC_TH
    # the static array: RP_BD + 64 rows a chunk, or the windowed kernel's none
    static_bytes = 4 * CHUNKS_PER_BLOCK * (RP_BD + _STATIC_TH) if static else 0
    row_bytes = 4 * CHUNKS_PER_BLOCK * (-(-ch // 32) + (0 if static else 1))
    fixed = (edge_mask_bytes(ch, 0) + static_bytes
             + (0 if static else 4 * CHUNKS_PER_BLOCK * RP_BD))
    win = window_rows(ch, tile_h, row_bytes, fixed,
                      step=tile_h if static else ss)
    smem = fixed - static_bytes + row_bytes * win
    return {"form": "shallow", "threads": THREADS,
            "chunks_per_block": CHUNKS_PER_BLOCK, "edge_window": 0,
            "window_rows": win, "windows": -(-tile_h // win),
            "staged_rows": RP_BD + (_STATIC_TH if static else win),
            "smem_bytes": smem, "shared_bytes": smem + static_bytes}


def coverage_chunks_res_cuda(pools: list, rparams: list, out: torch.Tensor,
                             tile_h: int, tile_w: int, ss: int) -> None:
    """Launch K3 once over the RES pools (one launch per
    coverage_cuda.MAX_POOLS pools): pools[i] (NC_i, CH_i, 4) edges +
    rparams[i] (RP_ROWS, NC_i) params -> out (sum NC_i, TH//ss*TW), pool
    i's rows after pool i-1's, written in place (the RES rows of
    cov_final)."""
    fn = "coverage_chunks_res_cuda"
    if not pools or len(pools) != len(rparams):
        raise ValueError(f"{fn}: {len(pools)} pools, {len(rparams)} rparams")
    if tile_w < 128 or tile_w % 128:
        raise ValueError(f"{fn}: tile_w={tile_w} (need a multiple of 128)")
    index = out.get_device()
    rows = rp_rows(tile_h)
    total = max_ch = 0
    for ce, rp in zip(pools, rparams):
        if not ce.is_cuda:
            raise ValueError(f"{fn}: edges on {ce.device}")
        nc, ch = ce.shape[0], ce.shape[1]
        if ch < 1:
            raise ValueError(f"{fn}: CH={ch}")
        check_tensor(fn, "edges", ce, torch.float32, (nc, ch, 4), index, 16)
        check_tensor(fn, "rparams", rp, torch.float32, (rows, nc), index)
        total += nc
        max_ch = max(max_ch, ch)
    geo = k3_geometry(tile_h, ss, max_ch)
    npx_out = (tile_h // ss) * tile_w
    check_tensor(fn, "out", out, torch.float32, (total, npx_out), index, 16)
    launch_pools(K3, "vg_coverage_chunks_res", pools, rparams, out, npx_out,
                 geo, tile_w, ss, tile_h // ss, geo["window_rows"] // ss)


def resolve_rows_cuda(cov_sub: torch.Tensor, ids: torch.Tensor,
                      rparams: torch.Tensor, out: torch.Tensor, tile_h: int,
                      tile_w: int, ss: int) -> None:
    """Launch K3's vg_resolve_rows: the rows ids of the folded sub-row
    coverage cov_sub (R, TH*TW) + (RP_ROWS, N) params -> out (N, TH//ss*TW),
    written in place.  ids are trusted to lie in [0, R) (checked on the host
    by raster/frame.plan_host_arrays)."""
    fn = "resolve_rows_cuda"
    if not cov_sub.is_cuda:
        raise ValueError(f"{fn}: cov_sub on {cov_sub.device}")
    if ss < 1 or tile_h < ss or tile_h % ss:
        raise ValueError(f"{fn}: tile_h={tile_h} sub-rows with ss={ss}")
    n = int(ids.shape[0])
    index = cov_sub.get_device()
    check_tensor(fn, "cov_sub", cov_sub, torch.float32,
                 (cov_sub.shape[0], tile_h * tile_w), index)
    check_tensor(fn, "ids", ids, torch.int32, (n,), index)
    check_tensor(fn, "rparams", rparams, torch.float32, (rp_rows(tile_h), n), index)
    check_tensor(fn, "out", out, torch.float32, (n, (tile_h // ss) * tile_w), index)
    K3.launch("vg_resolve_rows", cov_sub.data_ptr(), ids.data_ptr(),
              rparams.data_ptr(), out.data_ptr(), n, tile_w, ss, tile_h // ss,
              index, current_stream(index))
