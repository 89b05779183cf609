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

from vgtpu_torch.ops.composite import (
    _P_AA,
    _P_BD,
    _P_CTILE,
    _P_KIND,
    _P_OX,
    _P_OY,
    _P_PAINT,
    _P_PK,
    _P_RULE,
    _P_SC,
    _P_VALID,
)
from vgtpu_torch.utils.cuda_build import CudaKernel, check_tensor, current_stream

# csrc/composite_flat.cu's block: the one mirror of its constants
TILES = 32       # kTiles: tiles per block, one per threadIdx.x
GROUP = 32       # kGroup: pixels of each tile per block
PIX_WIDE, PIX_NARROW = 4, 2   # kPix of the wide and narrow forms
STAGES = 4       # kStages: ew ring depth
WINDOW = 32      # kWindow: slots staged per window at most
WINDOW_FLOATS = 16384   # kWindowFloats: the staged table's budget (64 KB)
META = 30        # kMeta: params rows 0..29, the most a slot stages
TEMPLATE_LANES = 4   # gradient, tri, texture, clip: the template bits

_vp = ctypes.c_void_p
_i = ctypes.c_int
K7 = CudaKernel("composite_flat", {"vg_composite_flat": [
    _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _vp,
]})


def k7_instantiation(flags) -> tuple:
    """(template bits G, runtime bits) of a bucket's seven lane flags
    (gradient, tri, texture, clip, even-odd, non-AA, scissor), as
    csrc/composite_flat.cu dispatches them: flags bit i is lane i; bits 0-3
    pick one of the 2**TEMPLATE_LANES instantiations
    composite_flat_kernel<G>, bits 4-6 pass as runtime values."""
    if len(flags) != 7:
        raise ValueError(f"K7: 7 lane flags, got {flags}")
    bits = sum(1 << i for i, on in enumerate(flags) if on)
    mask = (1 << TEMPLATE_LANES) - 1
    return bits & mask, bits & ~mask


def row_mask(g: int) -> int:
    """The params rows (of 0..META-1) instantiation g reads, as
    csrc/composite_flat.cu's row_mask: valid, rule, AA, paint kind, the
    scissor rect, the paint origin and the inner colour always; the kind
    row with clip (g bit 3), the colour-tile flag with texture (bit 2), the
    gradient's paint rows (bit 0) and the triangle's (bit 1)."""
    m = (1 << _P_VALID | 1 << _P_RULE | 1 << _P_AA | 1 << _P_PK | 0xF << _P_SC
         | 1 << _P_OX | 1 << _P_OY | 0xF << (_P_PAINT + 10))
    if g & 8:
        m |= 1 << _P_KIND
    if g & 4:
        m |= 1 << _P_CTILE
    if g & 1:
        m |= 0x3FF << _P_PAINT | 0xF << (_P_PAINT + 14)
    if g & 2:
        m |= 0xFFF << _P_PAINT
    return m


def k7_geometry(mo: int, npx: int, tile_w: int, nbo: int, add_backdrop: bool,
                g: int = 15, sms: int = 132) -> dict:
    """vg_composite_flat's launch geometry for one bucket of nbo tiles of npx
    pixels (tile_w a row) and mo slots in instantiation g
    (k7_instantiation), mirroring csrc/composite_flat.cu's geometry(): a
    block owns TILES tiles x GROUP pixels; each thread PIX_WIDE pixels (256
    threads), or PIX_NARROW (512) when the grid has fewer blocks than the
    card's `sms` SMs (132 on an H100 SXM; the entry point reads the card's
    own count); per window of min(mo, WINDOW) slots (fewer where
    WINDOW_FLOATS would not hold them) the block stages the params rows g
    reads (row_mask) and, with add_backdrop, the backdrop rows its pixel
    group spans (`backdrop_rows`), for each of its tiles, then a ring of
    STAGES x GROUP floats a tile: smem_bytes of dynamic shared memory, the
    same in both forms, which the entry point checks against its own."""
    if mo < 0 or tile_w < 1 or npx < tile_w or npx % tile_w:
        raise ValueError(f"K7: mo={mo}, npx={npx}, tile_w={tile_w}")
    th = npx // tile_w
    if tile_w % GROUP == 0:
        span = 1
    elif GROUP % tile_w == 0:
        span = GROUP // tile_w
    else:
        span = GROUP // tile_w + 2
    nbd = min(span, th) if add_backdrop else 0
    rows = bin(row_mask(g)).count("1") + nbd
    window = min(mo, WINDOW, WINDOW_FLOATS // (rows * TILES))
    smem = 4 * (window * rows * TILES + STAGES * GROUP * TILES)
    grid = (-(-nbo // TILES), -(-npx // GROUP))
    pix = PIX_NARROW if grid[0] * grid[1] < sms else PIX_WIDE
    return {"threads": TILES * GROUP // pix, "pixels_per_thread": pix,
            "grid": grid, "window": window, "backdrop_rows": nbd,
            "staged_rows": rows, "smem_bytes": smem}


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
    g, rt = k7_instantiation(flags)
    smem = k7_geometry(mo, npx, tile_w, nbo, add_backdrop, g)["smem_bytes"]
    out = torch.empty((4 * npx, nbo), dtype=torch.float32, device=dev)
    K7.launch("vg_composite_flat", ew_t.data_ptr(), params_t.data_ptr(), ct_ptr,
              bg_vec.data_ptr(), out.data_ptr(), nb, nbo, mo, npp, tile_w, npx,
              bg_cols, g | rt, int(bool(add_backdrop)), smem, index,
              current_stream(index))
    return out
