"""Kernel K8 (csrc/probe.cu) bound to torch: x * 2 + 1 on CUDA, the
cold-dispatch probe.

Replaces the Pallas kernel `k` of tools/probe_cold_tax.py's PALLAS probe.
The plain twin is utils/cold_probe.py::probe_affine_torch;
utils/cold_probe.py::probe_affine routes CUDA tensors here and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from vgtpu_torch.utils.cuda_build import CudaKernel, current_stream

K8 = CudaKernel("probe", {"vg_probe_affine": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]})


def probe_affine_cuda(x: torch.Tensor) -> torch.Tensor:
    """x * 2 + 1 elementwise for a contiguous float32 CUDA tensor: one K8
    launch on its device's current stream."""
    if not x.is_cuda:
        raise ValueError(f"probe_affine_cuda: x on {x.device}, not a CUDA device")
    n = x.numel()
    if x.dtype != torch.float32 or not x.is_contiguous() or n >= 2**31:
        raise ValueError(f"probe_affine_cuda: x must be contiguous float32 with "
                         f"< 2**31 elements, got {x.dtype} {tuple(x.shape)}")
    index = x.get_device()
    out = torch.empty_like(x)
    K8.launch("vg_probe_affine", x.data_ptr(), out.data_ptr(), n, index,
              current_stream(index))
    return out
