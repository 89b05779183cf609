"""Kernel K2 (csrc/composite.cu) bound to torch: one bucket of the fused
painter composite on CUDA.

Replaces vgtpu/ops/composite_pallas.py::_kernel_rows in all its forms: (a)
ss=1, (d) ss>1 over raw sub-row coverage, (e) over final coverage with
resolved-backdrop rows, each optionally with (b) per-tile init planes
(tiles start from their framebuffer rows) and (c) k_rep variant blocks
sharing one block of coverage rows.  The plain twin is ops/composite.py::
composite_bucket_into_torch; ops/composite.py::composite_bucket routes CUDA
tensors here and nowhere else.

K2.launches counts every launch; FORM_LAUNCHES counts them per form: each
launch adds one to its coverage form (a, d or e) and one to b and c when it
takes them.
"""

from __future__ import annotations

import ctypes

import torch

from vgtpu_torch.ops.composite import _P_BD
from vgtpu_torch.utils.cuda_build import CudaKernel, check_tensor, stream_ptr

MAX_THREADS = 256   # the kernel's launch bound: TH_OUT*TW/4 output pixels

_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
K2 = CudaKernel("composite", {"vg_composite_bucket": [
    _vp, _vp, _vp, _vp, _vp, _vp, _vp, _f, _f, _f, _f, _vp,
    _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _vp,
]})
FORM_LAUNCHES = dict.fromkeys("abcde", 0)


def composite_bucket_cuda(fb, cov, pteb, params, ct_flat, ctile, ids,
                          background, *, tile_w: int, flags: tuple,
                          ss: int = 1, rbd=None, init: bool = False,
                          k_rep: int = 1) -> None:
    """Launch K2 for one bucket: writes the bucket's tiles into
    fb (T+1, TH//ss, TW, 4) at rows ids (pad rows hit the scratch row T,
    the last row).  Without rbd, cov is raw sub-row coverage (NC+1, TH*TW)
    (forms (a)/(d)); with rbd (MO, RBR, NbP), cov is final coverage
    (R, TH//ss*TW) (form (e), no clip lane).  init (form (b)): each tile
    starts from its own fb row instead of the background.  k_rep > 1 (form
    (c)): pteb holds one variant block of NbP1 rows and params, ctile and
    ids k_rep * NbP1 (not with rbd).  background: the 4 premultiplied RGBA
    floats (host values, no sync)."""
    who = "composite_bucket_cuda"
    dev = fb.device
    if not fb.is_cuda:
        raise ValueError(f"composite_bucket_cuda: framebuffer on {dev}")
    nt1, th_out, tw, _c = fb.shape
    npx_out = th_out * tw
    th = th_out * ss                          # sub-rows
    if tw != tile_w:
        raise ValueError(f"composite_bucket_cuda: tile_w {tile_w} != fb {tw}")
    if ss < 1 or npx_out % 4 or npx_out // 4 > MAX_THREADS:
        raise ValueError(f"composite_bucket_cuda: {th_out}x{tw} output tiles "
                         f"at ss={ss}: K2 takes ss >= 1 and at most "
                         f"{4 * MAX_THREADS} output pixels per tile "
                         f"(npx_out/4 <= {MAX_THREADS} threads)")
    if len(flags) != 7:
        raise ValueError(f"composite_bucket_cuda: 7 lane flags, got {flags}")
    nbp1, mo = pteb.shape
    nbp = nbp1 * k_rep
    npp = params.shape[1]
    if k_rep < 1 or (k_rep > 1 and rbd is not None):
        raise ValueError(f"composite_bucket_cuda: k_rep={k_rep}; k_rep > 1 "
                         f"takes raw sub-row coverage (no rbd)")
    check_tensor(who, "fb", fb, torch.float32, (nt1, th_out, tw, 4), dev)
    check_tensor(who, "pteb", pteb, torch.int32, (nbp1, mo), dev)
    check_tensor(who, "params", params, torch.float32, (mo, npp, nbp), dev)
    check_tensor(who, "ids", ids, torch.int32, (nbp,), dev)
    rbd_ptr, rbr = None, 0
    if rbd is None:
        if npp < _P_BD + th:
            raise ValueError(f"composite_bucket_cuda: params rows {npp} < "
                             f"{_P_BD + th} ({th} sub-rows)")
        check_tensor(who, "cov", cov, torch.float32, (cov.shape[0], th * tw), dev)
    else:
        if flags[3]:
            raise ValueError("composite_bucket_cuda: final coverage (rbd) "
                             "with the clip lane")
        rbr = rbd.shape[1]
        if rbr < th_out:
            raise ValueError(f"composite_bucket_cuda: rbd rows {rbr} < {th_out}")
        check_tensor(who, "cov", cov, torch.float32, (cov.shape[0], npx_out), dev)
        check_tensor(who, "rbd", rbd, torch.float32, (mo, rbr, nbp), dev)
        rbd_ptr = rbd.data_ptr()
    ct_ptr = ctile_ptr = None
    if flags[2]:
        check_tensor(who, "ct_flat", ct_flat, torch.float32,
               (ct_flat.shape[0], 4 * npx_out), dev)
        check_tensor(who, "ctile", ctile, torch.int32, (nbp, mo), dev)
        ct_ptr, ctile_ptr = ct_flat.data_ptr(), ctile.data_ptr()
    bits = sum(1 << i for i, on in enumerate(flags) if on)
    bg = [float(v) for v in background]
    with torch.cuda.device(dev):
        K2.launch("vg_composite_bucket", _vp(cov.data_ptr()),
                  _vp(pteb.data_ptr()), _vp(params.data_ptr()), _vp(ct_ptr),
                  _vp(ctile_ptr), _vp(rbd_ptr), _vp(ids.data_ptr()), *bg,
                  _vp(fb.data_ptr()), nbp, nbp1, mo, npp, rbr, tw, npx_out,
                  ss, bits, int(bool(init)), nt1 - 1, stream_ptr(dev))
    FORM_LAUNCHES["e" if rbd is not None else "d" if ss > 1 else "a"] += 1
    if init:
        FORM_LAUNCHES["b"] += 1
    if k_rep > 1:
        FORM_LAUNCHES["c"] += 1
