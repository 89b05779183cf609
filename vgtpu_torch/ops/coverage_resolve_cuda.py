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

from vgtpu_torch.ops.coverage_resolve import rp_rows
from vgtpu_torch.utils.cuda_build import CudaKernel, check_tensor, stream_ptr

MAX_CH = 32    # edges per chunk the kernel's shared staging holds
MAX_TH = 64    # sub-rows per tile the kernel's shared rparams hold

_vp = ctypes.c_void_p
_i = ctypes.c_int
K3 = CudaKernel("coverage_resolve", {
    "vg_coverage_chunks_res": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _vp],
    "vg_resolve_rows": [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _vp],
})


def _check_tile(fn, tile_h, ss):
    if ss < 1 or tile_h % ss or not 1 <= tile_h <= MAX_TH:
        raise ValueError(f"{fn}: tile_h={tile_h} sub-rows with ss={ss} "
                         f"(need ss | tile_h <= {MAX_TH})")


def coverage_chunks_res_cuda(edges: torch.Tensor, rparams: torch.Tensor,
                             out: torch.Tensor, tile_h: int, tile_w: int,
                             ss: int) -> None:
    """Launch K3 on one pool: (NC, CH, 4) edges + (RP_ROWS, NC) params ->
    out (NC, TH//ss*TW), written in place (a row range of cov_final)."""
    fn = "coverage_chunks_res_cuda"
    dev = edges.device
    if not edges.is_cuda:
        raise ValueError(f"{fn}: edges on {dev}")
    _check_tile(fn, tile_h, ss)
    nc, ch = int(edges.shape[0]), int(edges.shape[1])
    if not 1 <= ch <= MAX_CH:
        raise ValueError(f"{fn}: CH={ch} outside 1..{MAX_CH}")
    check_tensor(fn, "edges", edges, torch.float32, (nc, ch, 4), dev)
    check_tensor(fn, "rparams", rparams, torch.float32, (rp_rows(tile_h), nc), dev)
    check_tensor(fn, "out", out, torch.float32, (nc, (tile_h // ss) * tile_w), dev)
    with torch.cuda.device(dev):
        K3.launch("vg_coverage_chunks_res", _vp(edges.data_ptr()),
                  _vp(rparams.data_ptr()), _vp(out.data_ptr()), nc, ch,
                  tile_w, ss, tile_h // ss, stream_ptr(dev))


def resolve_rows_cuda(cov_sub: torch.Tensor, ids: torch.Tensor,
                      rparams: torch.Tensor, out: torch.Tensor, tile_h: int,
                      tile_w: int, ss: int) -> None:
    """Launch K3's vg_resolve_rows: the rows ids of the folded sub-row
    coverage cov_sub (R, TH*TW) + (RP_ROWS, N) params -> out (N, TH//ss*TW),
    written in place.  ids are trusted to lie in [0, R) (checked on the host
    by raster/frame.plan_host_arrays)."""
    fn = "resolve_rows_cuda"
    dev = cov_sub.device
    if not cov_sub.is_cuda:
        raise ValueError(f"{fn}: cov_sub on {dev}")
    _check_tile(fn, tile_h, ss)
    n = int(ids.shape[0])
    check_tensor(fn, "cov_sub", cov_sub, torch.float32,
           (cov_sub.shape[0], tile_h * tile_w), dev)
    check_tensor(fn, "ids", ids, torch.int32, (n,), dev)
    check_tensor(fn, "rparams", rparams, torch.float32, (rp_rows(tile_h), n), dev)
    check_tensor(fn, "out", out, torch.float32, (n, (tile_h // ss) * tile_w), dev)
    with torch.cuda.device(dev):
        K3.launch("vg_resolve_rows", _vp(cov_sub.data_ptr()),
                  _vp(ids.data_ptr()), _vp(rparams.data_ptr()),
                  _vp(out.data_ptr()), n, tile_w, ss, tile_h // ss,
                  stream_ptr(dev))
