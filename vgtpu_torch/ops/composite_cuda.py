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
takes them.  k2_geometry is the kernel's launch geometry, a pure function
of the tile shape and the bucket's lanes.  A view window
(ops/coverage.ViewWindow) makes forms (a) and (d) composite only the tiles
a retained pan's view reaches, straight into the view's output.
"""

from __future__ import annotations

import array
import ctypes
import functools

import torch

from vgtpu_torch.ops.composite import _P_BD
from vgtpu_torch.utils.cuda_build import (
    SMEM_LIMIT,
    CudaKernel,
    check_tensor,
    current_stream,
)

# csrc/composite.cu: output pixels per thread, coverage ring depth (slots in
# flight), slots staged per window, params rows staged per slot
PIX, STAGES, WINDOW, META = 4, 3, 64, 30

_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
K2 = CudaKernel("composite", {"vg_composite_bucket": [
    _vp, _vp, _vp, _vp, _vp, _vp, _vp, _f, _f, _f, _f, _vp, _vp,
    _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _vp,
]})
FORM_LAUNCHES = dict.fromkeys("abcde", 0)


def k2_geometry(th_out: int, tile_w: int, ss: int, *, mo: int = 1,
                final: bool = False, clip: bool = False, tex: bool = False) -> dict:
    """K2's launch geometry for output tiles of th_out x tile_w at ss over
    a bucket of mo slots, mirroring csrc/composite.cu::geometry(): threads
    per block (256 at ss <= 2, else 128), each owning PIX consecutive output
    pixels of a row; pixel groups (blocks) per tile; the output rows a group
    spans; slot windows; the coverage ring's STAGES; and the dynamic shared
    bytes: the ring (ss 16-byte pieces per thread and stage, one in form
    (e)), the colour-tile ring (texture lane), the clip mask and
    accumulator (2*ss pieces per thread, clip lane), the window's slot
    tables.  final: form (e); clip, tex: the bucket's lanes.  Raises
    ValueError for a shape K2 cannot take (tile_w not a multiple of PIX)
    or the card cannot run (over SMEM_LIMIT)."""
    if ss < 1 or th_out < 1 or mo < 0 or tile_w < PIX or tile_w % PIX:
        raise ValueError(f"K2: {th_out}x{tile_w} output tiles at ss={ss}: "
                         f"K2 takes ss >= 1 and tile_w a multiple of {PIX}")
    if final and clip:
        raise ValueError("K2: final coverage (form (e)) with the clip lane")
    threads = 256 if ss <= 2 else 128
    group = threads * PIX
    span = group // tile_w + 2 if group % tile_w else group // tile_w
    rows = min(th_out, span)
    chunks = 1 if final else ss
    smem = (16 * threads * (STAGES * chunks + (4 * STAGES if tex else 0)
                            + (2 * ss if clip else 0))
            + 4 * (WINDOW * (META + rows * chunks) + 3 * WINDOW + 4))
    if smem > SMEM_LIMIT:
        raise ValueError(f"K2: {th_out}x{tile_w} output tiles at ss={ss} need "
                         f"{smem} shared bytes per block, over the card's "
                         f"{SMEM_LIMIT}")
    return {"threads": threads, "pixels_per_thread": PIX,
            "groups": -(-th_out * tile_w // group), "group_rows": rows,
            "windows": -(-mo // WINDOW), "stages": STAGES, "smem_bytes": smem}


@functools.lru_cache(maxsize=64)
def _view_words(window) -> array.array:
    """A view window as csrc/composite.cu's struct View reads it on the
    host at each launch: once a window, not once a bucket."""
    s_ty, s_tx, s_r, clip_w, clip_h = window.layout()
    return array.array("q", (*window.tiles, window.ntx, window.vx, window.vy,
                             clip_w, clip_h, s_ty, s_tx, s_r))


def composite_bucket_cuda(fb, cov, pteb, params, ct_flat, ctile, ids,
                          background, *, tile_w: int, flags: tuple,
                          ss: int = 1, rbd=None, init: bool = False,
                          k_rep: int = 1, window=None) -> None:
    """Launch K2 for one bucket: writes the bucket's tiles into
    fb (T+1, TH//ss, TW, 4) at rows ids (pad rows hit the scratch row T,
    the last row).  Without rbd, cov is raw sub-row coverage (NC+1, TH*TW)
    (forms (a)/(d)); with rbd (MO, RBR, NbP), cov is final coverage
    (R, TH//ss*TW) (form (e), no clip lane).  init (form (b)): each tile
    starts from its own fb row instead of the background.  k_rep > 1 (form
    (c)): pteb holds one variant block of NbP1 rows and params, ctile and
    ids k_rep * NbP1 (not with rbd).  background: the 4 premultiplied RGBA
    floats (host values, no sync).  fb, cov and ct_flat are 16-byte
    aligned (the kernel moves them as float4).

    window (ops/coverage.ViewWindow, forms (a) and (d) only): fb is the
    view's output (window.out_shape()); tiles outside window.tiles do no
    work and the others are written at their output positions."""
    who = "composite_bucket_cuda"
    if not fb.is_cuda:
        raise ValueError(f"composite_bucket_cuda: framebuffer on {fb.device}")
    index = fb.get_device()
    view = None
    if window is None:
        nt1, th_out, tw, _c = fb.shape
    else:
        if init or k_rep != 1 or rbd is not None:
            raise ValueError("composite_bucket_cuda: a view window takes "
                             "forms (a) and (d) only")
        th_out, tw, nt1 = window.th, window.tw, 1   # no scratch row: no init
        check_tensor(who, "out", fb, torch.float32, window.out_shape(), index, 16)
        view = _view_words(window)
    npx_out = th_out * tw
    th = th_out * ss                          # sub-rows
    if tw != tile_w:
        raise ValueError(f"composite_bucket_cuda: tile_w {tile_w} != fb {tw}")
    if len(flags) != 7:
        raise ValueError(f"composite_bucket_cuda: 7 lane flags, got {flags}")
    geo = k2_geometry(th_out, tw, ss, final=rbd is not None, clip=flags[3],
                      tex=flags[2])
    nbp1, mo = pteb.shape
    nbp = nbp1 * k_rep
    npp = params.shape[1]
    if k_rep < 1 or (k_rep > 1 and rbd is not None):
        raise ValueError(f"composite_bucket_cuda: k_rep={k_rep}; k_rep > 1 "
                         f"takes raw sub-row coverage (no rbd)")
    if window is None:
        check_tensor(who, "fb", fb, torch.float32, (nt1, th_out, tw, 4), index, 16)
    check_tensor(who, "pteb", pteb, torch.int32, (nbp1, mo), index)
    check_tensor(who, "params", params, torch.float32, (mo, npp, nbp), index)
    check_tensor(who, "ids", ids, torch.int32, (nbp,), index)
    rbd_ptr, rbr = None, 0
    if rbd is None:
        if npp < _P_BD + th:
            raise ValueError(f"composite_bucket_cuda: params rows {npp} < "
                             f"{_P_BD + th} ({th} sub-rows)")
        check_tensor(who, "cov", cov, torch.float32, (cov.shape[0], th * tw),
                     index, 16)
    else:
        rbr = rbd.shape[1]
        if rbr < th_out or npp < _P_BD:
            raise ValueError(f"composite_bucket_cuda: rbd rows {rbr} < {th_out} "
                             f"or params rows {npp} < {_P_BD}")
        check_tensor(who, "cov", cov, torch.float32, (cov.shape[0], npx_out),
                     index, 16)
        check_tensor(who, "rbd", rbd, torch.float32, (mo, rbr, nbp), index)
        rbd_ptr = rbd.data_ptr()
    ct_ptr = ctile_ptr = None
    if flags[2]:
        check_tensor(who, "ct_flat", ct_flat, torch.float32,
                     (ct_flat.shape[0], 4 * npx_out), index, 16)
        check_tensor(who, "ctile", ctile, torch.int32, (nbp, mo), index)
        ct_ptr, ctile_ptr = ct_flat.data_ptr(), ctile.data_ptr()
    bits = sum(1 << i for i, on in enumerate(flags) if on)
    r, g, b, a = (float(v) for v in background)
    K2.launch("vg_composite_bucket", cov.data_ptr(), pteb.data_ptr(),
              params.data_ptr(), ct_ptr, ctile_ptr, rbd_ptr, ids.data_ptr(),
              r, g, b, a, fb.data_ptr(),
              None if view is None else view.buffer_info()[0],
              nbp, nbp1, mo, npp, rbr, tw, npx_out,
              ss, bits, int(bool(init)), nt1 - 1, geo["smem_bytes"], index,
              current_stream(index))
    FORM_LAUNCHES["e" if rbd is not None else "d" if ss > 1 else "a"] += 1
    if init:
        FORM_LAUNCHES["b"] += 1
    if k_rep > 1:
        FORM_LAUNCHES["c"] += 1
