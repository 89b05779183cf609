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

from vgtpu_torch.ops.coverage_resolve import RP_BD, rp_rows
from vgtpu_torch.utils.cuda_build import CudaKernel, check_tensor, current_stream

MAX_CH = 32    # edges per chunk the kernel's shared staging holds
SMEM_LIMIT = 232_448   # shared bytes a block may use on an H100 (227 KB)
_CHUNKS_PER_BLOCK = 4  # csrc/coverage_resolve.cu kChunksPerBlock
_STATIC_TH = 64        # csrc/coverage_resolve.cu kStaticTh
_EDGE_SCALARS = 8      # csrc/edge_coverage.cuh kEdgeScalars

_vp = ctypes.c_void_p
_i = ctypes.c_int
K3 = CudaKernel("coverage_resolve", {
    "vg_coverage_chunks_res": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _vp],
    "vg_resolve_rows": [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _vp],
})


def k3_geometry(tile_h: int, ss: int) -> dict:
    """vg_coverage_chunks_res's launch geometry for tiles of tile_h
    sub-rows at ss, mirroring csrc/coverage_resolve.cu: 256 threads per
    block of 4 chunks; the per-edge scalars in static shared memory (4 *
    MAX_CH * 8 floats) and each chunk's rparams column: RP_BD + 64 rows in
    static shared memory up to 64 sub-rows, else RP_BD + tile_h rows in
    dynamic shared memory (smem_bytes, 0 in the static form).  Raises
    ValueError for a shape the card cannot run (over SMEM_LIMIT shared
    bytes per block)."""
    if ss < 1 or tile_h < ss or tile_h % ss:
        raise ValueError(f"K3: tile_h={tile_h} sub-rows with ss={ss} "
                         f"(need ss | tile_h)")
    rows = RP_BD + max(tile_h, _STATIC_TH)
    staging = 4 * _CHUNKS_PER_BLOCK * rows
    shared = 4 * _CHUNKS_PER_BLOCK * MAX_CH * _EDGE_SCALARS + staging
    if shared > SMEM_LIMIT:
        raise ValueError(f"K3: tile_h={tile_h} sub-rows need {shared} "
                         f"shared bytes per block, over the card's "
                         f"{SMEM_LIMIT}")
    return {"threads": 256, "chunks_per_block": _CHUNKS_PER_BLOCK,
            "staged_rows": rows,
            "smem_bytes": 0 if tile_h <= _STATIC_TH else staging,
            "shared_bytes": shared}


def coverage_chunks_res_cuda(edges: torch.Tensor, rparams: torch.Tensor,
                             out: torch.Tensor, tile_h: int, tile_w: int,
                             ss: int) -> None:
    """Launch K3 on one pool: (NC, CH, 4) edges + (RP_ROWS, NC) params ->
    out (NC, TH//ss*TW), written in place (a row range of cov_final)."""
    fn = "coverage_chunks_res_cuda"
    if not edges.is_cuda:
        raise ValueError(f"{fn}: edges on {edges.device}")
    smem = k3_geometry(tile_h, ss)["smem_bytes"]
    nc, ch = int(edges.shape[0]), int(edges.shape[1])
    if not 1 <= ch <= MAX_CH:
        raise ValueError(f"{fn}: CH={ch} outside 1..{MAX_CH}")
    index = edges.get_device()
    check_tensor(fn, "edges", edges, torch.float32, (nc, ch, 4), index)
    check_tensor(fn, "rparams", rparams, torch.float32, (rp_rows(tile_h), nc), index)
    check_tensor(fn, "out", out, torch.float32, (nc, (tile_h // ss) * tile_w), index)
    K3.launch("vg_coverage_chunks_res", edges.data_ptr(), rparams.data_ptr(),
              out.data_ptr(), nc, ch, tile_w, ss, tile_h // ss, smem, index,
              current_stream(index))


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
    k3_geometry(tile_h, ss)
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
