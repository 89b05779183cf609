"""Kernel K2 (csrc/composite.cu) bound to torch: one bucket of the fused
painter composite on CUDA.

Replaces vgtpu/ops/composite_pallas.py::_kernel_rows at ss=1.  The plain twin
is ops/composite.py::composite_bucket_into_torch; ops/composite.py::
composite_bucket routes CUDA tensors here and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from vgtpu_torch.ops.composite import _P_BD
from vgtpu_torch.utils.cuda_build import CudaKernel, stream_ptr

_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
K2 = CudaKernel("composite", "vg_composite_bucket", [
    _vp, _vp, _vp, _vp, _vp, _vp, _f, _f, _f, _f, _vp,
    _i, _i, _i, _i, _i, _i, _vp,
])


def _check(name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"composite_bucket_cuda: {name} on {t.device}, "
                         f"framebuffer on {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"composite_bucket_cuda: {name} must be {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"composite_bucket_cuda: {name} must be contiguous")


def composite_bucket_cuda(fb, cov_all, pteb, params, ct_flat, ctile, ids,
                          background, *, tile_w: int, flags: tuple) -> None:
    """Launch K2 for one bucket: writes the bucket's tiles into
    fb (T+1, TH, TW, 4) at rows ids (pad rows hit the scratch row T).
    background: the 4 premultiplied RGBA floats (host values, no sync)."""
    dev = fb.device
    if not fb.is_cuda:
        raise ValueError(f"composite_bucket_cuda: framebuffer on {dev}")
    nt1, th, tw, _c = fb.shape
    npx = th * tw
    if tw != tile_w:
        raise ValueError(f"composite_bucket_cuda: tile_w {tile_w} != fb {tw}")
    if npx % 4 or npx // 4 > 1024:
        raise ValueError(f"composite_bucket_cuda: {th}x{tw} tiles need "
                         f"npx/4 <= 1024 threads")
    nbp, mo = pteb.shape
    npp = params.shape[1]
    if npp < _P_BD + th:
        raise ValueError(f"composite_bucket_cuda: params rows {npp} < {_P_BD + th}")
    if len(flags) != 7:
        raise ValueError(f"composite_bucket_cuda: 7 lane flags, got {flags}")
    _check("fb", fb, torch.float32, (nt1, th, tw, 4), dev)
    _check("cov_all", cov_all, torch.float32, (cov_all.shape[0], npx), dev)
    _check("pteb", pteb, torch.int32, (nbp, mo), dev)
    _check("params", params, torch.float32, (mo, npp, nbp), dev)
    _check("ids", ids, torch.int32, (nbp,), dev)
    ct_ptr = ctile_ptr = None
    if flags[2]:
        _check("ct_flat", ct_flat, torch.float32, (ct_flat.shape[0], 4 * npx), dev)
        _check("ctile", ctile, torch.int32, (nbp, mo), dev)
        ct_ptr, ctile_ptr = ct_flat.data_ptr(), ctile.data_ptr()
    bits = sum(1 << i for i, on in enumerate(flags) if on)
    bg = [float(v) for v in background]
    with torch.cuda.device(dev):
        K2.launch(_vp(cov_all.data_ptr()), _vp(pteb.data_ptr()),
                  _vp(params.data_ptr()), _vp(ct_ptr), _vp(ctile_ptr),
                  _vp(ids.data_ptr()), *bg, _vp(fb.data_ptr()),
                  nbp, mo, npp, tw, npx, bits, stream_ptr(dev))
