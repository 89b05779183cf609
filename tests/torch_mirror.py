"""Run a vgtpu test's own body against vgtpu_torch, and hold the two runs to
each other frame by frame.

`mirror(module, name, **kwargs)` loads tests/<module>.py twice, once over
each package, with the module's `vg` bound to a `Shim` of that package, and
runs test `name` in both.  The port's run therefore makes every assertion of
vgtpu's test (pixels, op counts, cache and memo state), and the shims record
every frame that `vg.end` (and `vg.renderFrames`) returns, with the
profiler counters of the memos and layers (COUNTERS), and every FramePlan a
context bins (a frame, its suffix under a layer, a layer bake), as it stands
after Context._fill_textures, before the upload.  The two runs must bin the
same FramePlans, equal bit for bit (colour tiles, which the device samplers
compute, within 2e-6), and give the same number of frames, images within
`atol` and the same counters after each frame.

The port's copy of the module has its `vgtpu.` imports pointed at
`vgtpu_torch.`; the port's contexts render on the CPU.  vgtpu renders
through its XLA path on the CPU (its Pallas kernels are TPU-only there)."""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np
import torch

import vgtpu as vgj
import vgtpu_torch as vgt

TESTS = Path(__file__).parent
ATOL = 2e-6           # images, port against vgtpu
ATOL_CT = 2e-6        # colour tiles of the device samplers
# the shortcut counters, which must move frame by frame as vgtpu's do
COUNTERS = ("memo_hits", "memo_paint_hits", "ct_memo_hits", "layer_hits",
            "layer_prefix_ops", "layer_bakes", "layer_cl_hits",
            "layer_cl_bakes", "ops", "entries")


def to_np(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plan_snapshot(plan):
    """The FramePlan's fields as host arrays (colour tiles may live on a
    device), copied: later frames patch plans in place."""
    if plan is None:
        return None
    out = {}
    for k, v in dataclasses.asdict(plan).items():
        if k == "color_tiles":
            v = to_np(v)
        out[k] = _copy(v)
    return out


def _copy(v):
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, dict):
        return {k: _copy(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_copy(x) for x in v)
    return v


class Shim:
    """A package as a vgtpu test body sees it (its module-global `vg`):
    attributes forward to the package, createContext makes the port's
    contexts on the CPU, and end/renderFrames record each frame."""

    def __init__(self, pkg):
        self._pkg = pkg
        self.frames = []
        self.plans = []

    def __getattr__(self, name):
        return getattr(self._pkg, name)

    def createContext(self, allocator=None, cfg=None):
        if self._pkg is vgt:
            return vgt.createContext(allocator, cfg, device="cpu")
        return vgj.createContext(allocator, cfg)

    def end(self, ctx, background=None, dispatch=True):
        out = self._pkg.end(ctx, background, dispatch)
        self._record(ctx, out)
        return out

    def _record(self, ctx, img):
        c = ctx.profiler.counters
        self.frames.append((to_np(img), {k: c.get(k, 0) for k in COUNTERS}))

    def renderFrames(self, ctxs, backgrounds=None):
        imgs = self._pkg.renderFrames(ctxs, backgrounds)
        for c, img in zip(ctxs, imgs):
            self._record(c, img)
        return imgs


def load(module: str, shim: Shim) -> dict:
    """tests/<module>.py executed over the shim's package, its `vg` bound
    to the shim: returns the module's namespace."""
    path = TESTS / f"{module}.py"
    src = path.read_text()
    src = re.sub(r"^(\s*)import vgtpu as vg\s*$", r"\1vg = __vg__", src,
                 flags=re.M)
    if shim._pkg is vgt:
        src = re.sub(r"\bfrom vgtpu(\.| import)", r"from vgtpu_torch\1", src)
    ns = {"__name__": f"mirror_{shim._pkg.__name__}_{module}",
          "__file__": str(path), "__vg__": shim}
    exec(compile(src, str(path), "exec"), ns)
    return ns


def _assert_same(a, b, path):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def assert_plans_equal(pj: dict, pt: dict, what: str) -> None:
    assert (pj is None) == (pt is None), what
    if pj is None:
        return
    assert sorted(pj) == sorted(pt), what
    for k in pj:
        if k == "color_tiles":
            a, b = pj[k], pt[k]
            assert a.shape == b.shape, f"{what}: color_tiles"
            np.testing.assert_allclose(b, a, atol=ATOL_CT, rtol=0,
                                       err_msg=f"{what}: color_tiles")
        else:
            _assert_same(pj[k], pt[k], f"{what}: plan.{k}")


def compare_frames(fj: list, ft: list, atol: float = ATOL,
                   what: str = "") -> None:
    assert len(fj) == len(ft), f"{what}: {len(fj)} vgtpu frames, {len(ft)} port"
    for i, ((ij, cj), (it, ct)) in enumerate(zip(fj, ft)):
        w = f"{what} frame {i}"
        assert ct == cj, f"{w}: counters {ct}, vgtpu {cj}"
        assert (ij is None) == (it is None), w
        if ij is not None:
            assert ij.shape == it.shape, w
            np.testing.assert_allclose(it, ij, atol=atol, rtol=0, err_msg=w)


def _run(pkg, call) -> Shim:
    """call(shim) over `pkg`, recording every plan Context._fill_textures
    fills."""
    shim = Shim(pkg)
    cls = pkg.Context
    fill = cls._fill_textures

    def recorded(ctx, plan, *a, **k):
        fill(ctx, plan, *a, **k)
        shim.plans.append(plan_snapshot(plan))

    cls._fill_textures = recorded
    try:
        call(shim)
    finally:
        cls._fill_textures = fill
    return shim


def run_both(call, atol: float = ATOL, what: str = "") -> tuple:
    """call(vg) over a Shim of vgtpu, then of the port; the two runs must
    bin the same plans and give the same frames.  Returns both shims."""
    sj, st = _run(vgj, call), _run(vgt, call)
    assert len(sj.plans) == len(st.plans), (
        f"{what}: {len(sj.plans)} vgtpu plans, {len(st.plans)} port")
    for i, (pj, pt) in enumerate(zip(sj.plans, st.plans)):
        assert_plans_equal(pj, pt, f"{what} plan {i}")
    compare_frames(sj.frames, st.frames, atol, what)
    return sj, st


def mirror(module: str, name: str, *args, atol: float = ATOL, **kwargs):
    """Run test `name` of tests/<module>.py over vgtpu, then over the port,
    and compare the runs (run_both)."""
    return run_both(lambda shim: load(module, shim)[name](*args, **kwargs),
                    atol, f"{module}::{name}")
