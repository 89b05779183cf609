"""The port's cold-start probe, counterpart of tools/probe_cold_tax.py, and
the entry point of kernel K8 (csrc/probe.cu), the probe's kernel.

Run on a machine with a CUDA card, from the root of a checkout:

    python3 -m vgtpu_torch.utils.cold_probe

Each phase runs in a fresh `python3 -c` process with jax blocked
(sys.modules["jax"] = None), so no state of an earlier phase or of the
caller hides a cost:

  1. torch: CUDA context creation, then a first cuBLAS matmul + sin on a
     (256, 128) float32 array, fetched to the host;
  2. K8: build or load its library (nvcc runs only when build/cuda/ has no
     library for the source), the first launch to a fetch of its result, a
     second launch;
  3. the 1080p frame: createContext(device="cuda") -> begin ->
     draw_benchmark_frame -> end() -> the first fetch of a pixel.

Each phase prints one JSON line of seconds, and whether an nvcc build ran in
it (a CudaKernel's build_seconds > 0); main() prints the three lines.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SHAPE = (256, 128)

_PRELUDE = """
import sys, time, json
sys.modules["jax"] = None
t_start = time.perf_counter()
sys.path.insert(0, {repo!r})
import torch
t_import = time.perf_counter()
"""

PHASES = {
    "torch": """
x = torch.ones({shape}, device="cuda")
torch.cuda.synchronize()
t0 = time.perf_counter()
y = (x @ x.T).sum() + torch.sin(x).sum()
t1 = time.perf_counter()
float(y)
t2 = time.perf_counter()
out = {{"import_s": t_import - t_start, "context_s": t0 - t_import,
        "dispatch_s": t1 - t0, "first_exec_fetch_s": t2 - t1, "nvcc_ran": False}}
""",
    "K8": """
from vgtpu_torch.ops.probe_cuda import K8
from vgtpu_torch.utils.cold_probe import probe_affine, probe_affine_torch
t_pkg = time.perf_counter()
x = torch.ones({shape}, device="cuda")
torch.cuda.synchronize()
t0 = time.perf_counter()
K8.build()
t1 = time.perf_counter()
y = probe_affine(x)
t2 = time.perf_counter()
float(y[0, 0])
t3 = time.perf_counter()
y2 = probe_affine(x)
float(y2[0, 0])
t4 = time.perf_counter()
err = float((y - probe_affine_torch(x)).abs().max())
out = {{"import_s": t_import - t_start, "package_s": t_pkg - t_import,
        "context_s": t0 - t_pkg, "build_or_load_s": t1 - t0, "dispatch_s": t2 - t1,
        "first_exec_fetch_s": t3 - t2, "second_s": t4 - t3,
        "nvcc_ran": K8.build_seconds > 0, "launches": K8.launches,
        "max_abs_err": err}}
""",
    "frame": """
import vgtpu_torch as vg
from vgtpu_torch.ops.composite_cuda import K2
from vgtpu_torch.ops.coverage_cuda import K1
from vgtpu_torch.scenes.demo_ui import draw_benchmark_frame
t0 = time.perf_counter()   # the package imported, no CUDA context yet
ctx = vg.createContext(device="cuda")
vg.begin(ctx, 0, 1920, 1080, 1.0)
draw_benchmark_frame(ctx, 0.0)
img = vg.end(ctx, background=(0.12, 0.12, 0.13, 1.0))
t1 = time.perf_counter()
px = img[0, 0].cpu()
t2 = time.perf_counter()
out = {{"import_s": t_import - t_start, "package_s": t0 - t_import,
        "first_frame_s": t1 - t0,
        "first_fetch_s": t2 - t1,
        "nvcc_ran": any((k.build_seconds or 0) > 0 for k in (K1, K2)),
        "launches": {{"K1": K1.launches, "K2": K2.launches}},
        "shape": list(img.shape), "finite": bool(torch.isfinite(img).all())}}
""",
}
_EPILOGUE = """
out["wall_s"] = time.perf_counter() - t_start
print(json.dumps(out))
"""


def probe_affine_torch(x: torch.Tensor) -> torch.Tensor:
    """x * 2 + 1: the plain twin of kernel K8."""
    return x * 2.0 + 1.0


def probe_affine(x: torch.Tensor) -> torch.Tensor:
    """x * 2 + 1 elementwise: kernel K8 on CUDA, the plain twin on the CPU."""
    dev = x.device
    if dev.type == "cuda":
        from vgtpu_torch.ops.probe_cuda import probe_affine_cuda

        return probe_affine_cuda(x)
    if dev.type == "cpu":
        return probe_affine_torch(x)
    raise ValueError(f"probe_affine: unsupported device {dev}")


def phase_code(name: str, repo: str = REPO) -> str:
    """The `python3 -c` program of phase `name`."""
    return (_PRELUDE.format(repo=repo) + PHASES[name].format(shape=SHAPE)
            + _EPILOGUE)


def run_phase(name: str, repo: str = REPO, timeout: float = 600) -> dict:
    """Phase `name` in a fresh process; its JSON line as a dict, with the
    phase's name.  Raises if the process fails."""
    proc = subprocess.run([sys.executable, "-c", phase_code(name, repo)],
                          cwd=repo, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"cold probe phase {name} failed (rc={proc.returncode}):"
                           f"\n{proc.stderr[-3000:]}")
    return {"phase": name, **json.loads(proc.stdout.strip().splitlines()[-1])}


def main() -> int:
    if not torch.cuda.is_available():
        print("cold_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    for name in PHASES:
        print(json.dumps(run_phase(name)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
