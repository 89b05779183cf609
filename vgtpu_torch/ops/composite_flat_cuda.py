"""Kernel K7 (csrc/composite_flat.cu) bound to torch: one bucket of the
painter composite over dense slot-major winding, on CUDA.

Replaces vgtpu/ops/composite_pallas.py::_kernel (composite_bucket_pallas,
variant "flat"), ss=1 only, with add_backdrop, per-tile init planes and
k_rep variant blocks.  The plain twin is ops/composite.py::
composite_bucket_torch; ops/composite.py::composite_bucket_flat routes CUDA
tensors here and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from vgtpu_torch.ops.composite import _P_BD
from vgtpu_torch.utils.cuda_build import CudaKernel, check_tensor, current_stream

_vp = ctypes.c_void_p
_i = ctypes.c_int
K7 = CudaKernel("composite_flat", {"vg_composite_flat": [
    _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _vp,
]})


def composite_bucket_flat_cuda(ew_t, params_t, ct_t, bg_vec, *, tile_w: int,
                               flags: tuple, add_backdrop: bool = False,
                               k_rep: int = 1) -> torch.Tensor:
    """Launch K7 for one bucket -> fb_t (4*NPX, k_rep*Nb) channel-major.
    ew_t (MO, NPX, Nb) winding; params_t (MO, NPP, k_rep*Nb), with the
    backdrop rows when add_backdrop; ct_t (MO, 4*NPX, k_rep*Nb) with the
    texture lane, else ignored; bg_vec (4*NPX, 1) the background column or
    (4*NPX, k_rep*Nb) a per-tile init plane.  All float32, contiguous, on
    ew_t's CUDA device."""
    dev = ew_t.device
    if not ew_t.is_cuda:
        raise ValueError(f"composite_bucket_flat_cuda: ew_t on {dev}, not a "
                         f"CUDA device")
    if len(flags) != 7:
        raise ValueError(f"composite_bucket_flat_cuda: 7 lane flags, got {flags}")
    if ew_t.dim() != 3 or k_rep < 1:
        raise ValueError(f"composite_bucket_flat_cuda: ew_t {tuple(ew_t.shape)}, "
                         f"k_rep={k_rep}")
    mo, npx, nb = (int(n) for n in ew_t.shape)
    nbo = k_rep * nb
    npp = params_t.shape[1] if params_t.dim() == 3 else 0
    if nb < 1 or npx % tile_w or npp < _P_BD + (npx // tile_w if add_backdrop else 0):
        raise ValueError(f"composite_bucket_flat_cuda: {nb} tiles of {npx} "
                         f"pixels, tile_w {tile_w}, {npp} params rows")
    who = "composite_bucket_flat_cuda"
    index = ew_t.get_device()
    check_tensor(who, "ew_t", ew_t, torch.float32, (mo, npx, nb), index)
    check_tensor(who, "params_t", params_t, torch.float32, (mo, npp, nbo), index)
    bg_cols = bg_vec.shape[1] if bg_vec.dim() == 2 else 0
    if bg_cols not in (1, nbo):
        raise ValueError(f"composite_bucket_flat_cuda: bg_vec "
                         f"{tuple(bg_vec.shape)}, expected (4*NPX, 1 or {nbo})")
    check_tensor(who, "bg_vec", bg_vec, torch.float32, (4 * npx, bg_cols), index)
    ct_ptr = None
    if flags[2]:
        check_tensor(who, "ct_t", ct_t, torch.float32, (mo, 4 * npx, nbo), index)
        ct_ptr = ct_t.data_ptr()
    bits = sum(1 << i for i, on in enumerate(flags) if on)
    out = torch.empty((4 * npx, nbo), dtype=torch.float32, device=dev)
    K7.launch("vg_composite_flat", ew_t.data_ptr(), params_t.data_ptr(), ct_ptr,
              bg_vec.data_ptr(), out.data_ptr(), nb, nbo, mo, npp, tile_w, npx,
              bg_cols, bits, int(bool(add_backdrop)), index,
              current_stream(index))
    return out
