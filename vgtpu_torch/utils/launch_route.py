"""Host cost of the port's kernel launch route, step by step, on a CUDA card.

Run on a machine with a card, from the root of a checkout:

    python3 -m vgtpu_torch.utils.launch_route

It times kernel K8's wrapper (ops/probe_cuda.probe_affine_cuda, x * 2 + 1)
on the cold probe's (256, 128) float32 input beside one PyTorch call of the
same function, torch.add(1, x, alpha=2), and each step of a wrapper's
route, in host microseconds per call: the mean over `calls` back-to-back
calls, no synchronisation inside the loop, the median of `repeats` such
loops after a warm-up loop.  The route's steps (ROUTE_STEPS, what
chip_smoke.py [6] times):

  checks          x.is_cuda, dtype, contiguity and size, as probe_affine_cuda
  empty_like      torch.empty_like(x), the output
  stream_raw      torch._C._cuda_getCurrentRawStream(index), an int
  size_check      t.shape != shape beside t.get_device() != index
  library_call    K8's bound ctypes entry point alone, its arguments
                  prepared: the foreign call, the kernel launch and
                  cudaGetLastError
  wrapper         probe_affine_cuda(x), the whole route
  torch_add       torch.add(one, x, alpha=2.0)

and, run as a program, also the steps of the route before the entry
points took the device index (EARLIER_STEPS), the "before" of PERF.md's
per-step table:

  device_context  entering and leaving torch.cuda.device(x.device)
  stream_object   ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream):
                  a torch.cuda.Stream object per call
  c_void_p        one ctypes.c_void_p(x.data_ptr()) wrapper
  tuple_check     tuple(t.shape) != tuple(shape) beside t.device != dev
  build_check     CudaKernel.build() on a built kernel (returns at once)

The entry point's signature is read from K8's argtypes (with or without
the device argument), so the program also times a checkout whose wrappers
still take the device context and the stream object (run it with that
checkout first on PYTHONPATH).  Prints one JSON object; exits 1 without a
card.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys
import time

import torch

SHAPE = (256, 128)
ROUTE_STEPS = ("checks", "empty_like", "stream_raw", "size_check",
               "library_call", "wrapper", "torch_add")
EARLIER_STEPS = ("device_context", "stream_object", "c_void_p", "tuple_check",
                 "build_check")


def per_call_us(fn, calls: int = 2000, repeats: int = 5) -> float:
    """Median over `repeats` loops of the mean host microseconds per call
    of fn() over `calls` back-to-back calls (after one warm-up loop); the
    card is synchronised between loops, never inside one."""
    loops = []
    for r in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter_ns()
        if r:
            loops.append((t1 - t0) / calls / 1e3)
    torch.cuda.synchronize()
    return statistics.median(loops)


def measure(x: torch.Tensor, steps: tuple = ROUTE_STEPS, calls: int = 2000,
            repeats: int = 5) -> dict:
    """Host us per call of each of `steps` (module docstring) for the CUDA
    float32 tensor x."""
    from vgtpu_torch.ops.probe_cuda import K8, probe_affine_cuda

    dev, index = x.device, x.get_device()
    one = torch.ones_like(x)
    out = torch.empty_like(x)
    K8.build()
    entry = K8._fns["vg_probe_affine"]
    n = x.numel()
    stream = torch._C._cuda_getCurrentRawStream(index)
    if len(K8.entries["vg_probe_affine"]) == 5:        # (x, out, n, device, stream)
        args = (x.data_ptr(), out.data_ptr(), n, index, stream)
    else:                                              # (x, out, n, stream)
        args = (x.data_ptr(), out.data_ptr(), n, stream)
    shape = tuple(x.shape)

    def checks():
        return (x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()
                and x.numel() < 2**31)

    def device_context():
        with torch.cuda.device(dev):
            pass

    def tuple_check():
        return x.device != dev or tuple(x.shape) != tuple(shape)

    def size_check():
        return x.get_device() != index or x.shape != shape

    fns = {
        "checks": checks,
        "empty_like": lambda: torch.empty_like(x),
        "device_context": device_context,
        "stream_object": lambda: ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(index),
        "c_void_p": lambda: ctypes.c_void_p(x.data_ptr()),
        "tuple_check": tuple_check,
        "size_check": size_check,
        "build_check": K8.build,
        "library_call": lambda: entry(*args),
        "wrapper": lambda: probe_affine_cuda(x),
        "torch_add": lambda: torch.add(one, x, alpha=2.0),
    }
    res = {name: per_call_us(fns[name], calls, repeats) for name in steps}
    res["wrapper_over_torch_add"] = res["wrapper"] / res["torch_add"]
    res["calls"], res["repeats"] = calls, repeats
    res["entry_args"] = len(args)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_route: torch sees no CUDA device", file=sys.stderr)
        return 1
    x = torch.randn(SHAPE, device="cuda")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "host_us_per_call": measure(x, ROUTE_STEPS + EARLIER_STEPS)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
