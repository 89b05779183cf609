"""Kernel S1 (csrc/sample_tiles.cu) bound to torch: every sampling group's
colour tiles in one launch, tile-major, written in K2's flat layout.

Replaces no TPU kernel (vgtpu's sampler is plain XLA): it was added because
the plain sampler materialises O(K * TW * IW) hat weights.  The plain twin
is ops/sampling_device.py::sample_groups (with ops/composite.flat_color_tiles);
ops/sampling_device.py::sample_tiles_flat routes CUDA groups here and
nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from vgtpu_torch.ops.sampling_device import DeviceGroups
from vgtpu_torch.utils.cuda_build import CudaKernel, current_stream

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
S1 = CudaKernel("sample_tiles", {"vg_sample_tiles": [
    _vp, _i, _i, _i, _i, _i, _vp, _i, _i, _i, _f, _f, _i, _vp,
]})


def sample_tiles_cuda(g: DeviceGroups, shift=(0.0, 0.0)) -> torch.Tensor:
    """(NCT+1, 4*th*tw) float32 colour tiles at the groups' tile size
    g.tile = (th, tw), channel-major, the last row zeros: one S1 launch on
    the groups' device and its current stream.
    shift (sx, sy): float32 amounts added to every tile origin, as
    sample_groups' shift."""
    w, (th, tw) = g.words, g.tile
    if not w.is_cuda:
        raise ValueError(f"sample_tiles_cuda: groups on {w.device}, not a CUDA device")
    if w.dtype != torch.int32 or w.dim() != 1 or not w.is_contiguous():
        raise ValueError(f"sample_tiles_cuda: words must be contiguous 1-d int32, got "
                         f"{w.dtype} {tuple(w.shape)}")
    if w.numel() >= 2**31 or th < 1 or tw < 1:
        raise ValueError(f"sample_tiles_cuda: {w.numel()} words, tiles {th}x{tw}")
    index = w.get_device()
    for t in g.texs:
        if (t.get_device() != index or t.dtype != torch.float32 or t.dim() != 3
                or t.shape[2] not in (1, 4) or not t.is_contiguous()):
            raise ValueError(f"sample_tiles_cuda: a texture must be a contiguous "
                             f"float32 (h, w, 1 or 4) tensor on cuda:{index}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    nct = g.num_tiles
    out = torch.empty((nct + 1, 4 * th * tw), dtype=torch.float32, device=w.device)
    at = g.at
    S1.launch("vg_sample_tiles", w.data_ptr(), at["rows"], at["offsets"], at["clip"],
              at["order"], at["pairs"], out.data_ptr(), nct, th, tw, float(shift[0]),
              float(shift[1]), index, current_stream(index))
    return out
