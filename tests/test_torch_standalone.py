"""vgtpu_torch's public surface, its standalone path/stroker seam
(api/standalone.py) and the vgpp helper (helpers/vgpp.py) against vgtpu.

The tests of tests/test_standalone.py run their own bodies over both
packages (tests/torch_mirror.py), except the concave fill, whose render
takes the port's execute_plan with an explicit device; the meshes the
standalone functions return must be equal in both packages.  The symbol
lists of tests/test_api_surface.py must all exist in vgtpu_torch, and none
of the vg.h entry points may raise NotImplementedError.  A vgpp Renderer
and Shape drawing renders within 2e-6 of vgtpu's."""

from __future__ import annotations

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores
torch.set_num_threads(1)

import vgtpu as vgj  # noqa: E402
import vgtpu_torch as vgt  # noqa: E402
from tests.test_api_surface import (  # noqa: E402
    STANDALONE_FUNCTIONS,
    TYPES,
    VG_H_FUNCTIONS,
)
from tests.torch_mirror import ATOL, mirror  # noqa: E402


@pytest.mark.parametrize("name", [
    "test_vg_header_symbol_parity",
    "test_standalone_path_flatten",
    "test_standalone_stroker_polyline",
    "test_standalone_convex_fill_fan",
    "test_cl_reset_alias",
])
def test_standalone_matches_vgtpu(name):
    mirror("test_standalone", name)


def test_standalone_concave_fill():
    """tests/test_standalone.py's concave fill: the ring's edges render
    through the port's frame pipeline (on the CPU) with the hole kept."""
    from vgtpu_torch.raster.binning import RasterOp, bin_frame, make_solid_paint
    from vgtpu_torch.raster.frame import execute_plan

    s = vgt.createStroker()
    assert vgt.strokerConcaveFillBegin(s)
    outer = np.array([[0, 0], [60, 0], [60, 60], [0, 60]], np.float32)
    hole = np.array([[20, 20], [20, 40], [40, 40], [40, 20]], np.float32)
    vgt.strokerConcaveFillAddContour(s, outer, 4)
    vgt.strokerConcaveFillAddContour(s, hole, 4)
    m = vgt.strokerConcaveFillEnd(s, None, vgt.FillRule.NonZero)
    assert len(m.contours) == 2 and len(m.edges) == 8
    assert m.fill_rule == vgt.FillRule.NonZero
    op = RasterOp(edges=m.edges,
                  paint=make_solid_paint(np.array([1, 1, 1, 1], np.float32)))
    img = execute_plan(bin_frame([op], 64, 64), background=(0, 0, 0, 0),
                       device="cpu").numpy()[..., 3]
    assert img[10, 10] > 0.99 and img[30, 30] < 0.01


def _meshes(vg):
    """Every standalone constructor on one input set."""
    p = vg.createPath()
    vg.pathReset(p, 1.0, 0.25)
    vg.pathMoveTo(p, 10, 10)
    vg.pathCubicTo(p, 40, 0, 80, 60, 110, 30)
    vg.pathQuadraticTo(p, 120, 50, 100, 70)
    vg.pathArcTo(p, 60, 90, 20, 70, 12)
    vg.pathClose(p)
    vg.pathRoundedRectVarying(p, 5, 5, 40, 30, 2, 4, 6, 8)
    vg.pathEllipse(p, 70, 40, 20, 10)
    vg.pathArc(p, 30, 60, 15, 0.2, 2.5, vg.Winding.CW)
    out = [vg.pathGetVertices(p), vg.pathGetSubPaths(p)]
    s = vg.createStroker()
    vg.strokerReset(s, 1.0, 0.25, 1.0)
    pts = np.array([[10, 10], [90, 12], [70, 60], [20, 50]], np.float32)
    out.append(vg.strokerPolylineStroke(s, None, pts, 4, False, 6.0,
                                        vg.LineCap.Square, vg.LineJoin.Bevel))
    out.append(vg.strokerPolylineStrokeAA(s, None, pts, 4, True, 0xFF00FF00,
                                          3.0, vg.LineCap.Round,
                                          vg.LineJoin.Miter))
    out.append(vg.strokerPolylineStrokeAAThin(s, None, pts, 4, False, 0xFFFFFFFF,
                                              vg.LineCap.Butt, vg.LineJoin.Round))
    out.append(vg.strokerConvexFillAA(s, None, pts, 4, 0x80FFFFFF))
    vg.strokerConcaveFillBegin(s)
    vg.strokerConcaveFillAddContour(s, pts, 4)
    out.append(vg.strokerConcaveFillEndAA(s, None, 0xFF0000FF, vg.FillRule.EvenOdd))
    return out


def _same(a, b, what):
    if hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            _same(getattr(a, f), getattr(b, f), f"{what}.{f}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(b, a, err_msg=what)
    else:
        assert a == b, what


def test_standalone_meshes_match_vgtpu():
    _same(_meshes(vgj), _meshes(vgt), "standalone")


def test_vg_h_surface_complete():
    missing = [f for f in VG_H_FUNCTIONS if not callable(getattr(vgt, f, None))]
    assert not missing, f"vg.h functions missing from vgtpu_torch: {missing}"


def test_standalone_surface_complete():
    missing = [f for f in STANDALONE_FUNCTIONS
               if not callable(getattr(vgt, f, None))]
    assert not missing, f"path.h/stroker.h functions missing: {missing}"


def test_types_exposed():
    missing = [t for t in TYPES if getattr(vgt, t, None) is None]
    assert not missing, f"types missing from vgtpu_torch: {missing}"


def test_debug_seams(monkeypatch, capsys):
    monkeypatch.delenv("VGTPU_DEBUG", raising=False)
    vgt.debugPrintf("quiet %d", 1)
    vgt.debugBreak()
    assert capsys.readouterr().err == ""
    monkeypatch.setenv("VGTPU_DEBUG", "1")
    vgt.debugPrintf("hello %d %s", 7, "x")
    assert "vg hello 7 x" in capsys.readouterr().err


def test_no_entry_point_is_a_stub():
    """Every vg.h and standalone name is a real function: none raises
    NotImplementedError (the port's stubs for unported features are
    gone), and the package exports what vgtpu exports."""
    stubs = [f for f in VG_H_FUNCTIONS + STANDALONE_FUNCTIONS
             if "NotImplementedError" in inspect.getsource(getattr(vgt, f))]
    assert not stubs, stubs
    missing = sorted(n for n in dir(vgj) if not n.startswith("_")
                     and not inspect.ismodule(getattr(vgj, n))
                     and not hasattr(vgt, n))
    assert not missing, missing


def _vgpp_frame(vg, renderer):
    r = renderer
    r.begin_frame(160, 80)
    badge = r.create_shape()
    with badge:             # a Cacheable list with a list-local gradient
        grad = r.linear_gradient(4, 0, 60, 0, vg.Colors.Red, vg.Colors.Blue)
        r.begin_path().rounded_rect(4, 4, 56, 28, 6).fill(grad)
        r.begin_path().circle(18, 18, 8).stroke(vg.Colors.White, 2.0)
    r.begin_path().rect(0, 0, 160, 80).fill(vg.color4ub(30, 30, 40, 255))
    for k in range(3):
        r.push_state().translate(50 * k, 10 * k).global_alpha(0.5 + 0.2 * k)
        r.submit(badge)
        r.pop_state()
    r.begin_path().move_to(10, 70).cubic_to(50, 40, 110, 90, 150, 60)
    r.stroke(vg.color4ub(250, 220, 60, 255), 3.0, vg.StrokeFlags.RoundRoundAA)
    img = r.end_frame(background=(0.1, 0.1, 0.1, 1.0))
    assert float(np.asarray(img)[30, 120, 0]) > 0.5     # the third badge
    return img, r.readback()


def test_vgpp_renderer_matches_vgtpu():
    from vgtpu.helpers.vgpp import Renderer as RendererJ
    from vgtpu_torch.helpers.vgpp import Renderer

    want, want_u8 = _vgpp_frame(vgj, RendererJ())
    got, got_u8 = _vgpp_frame(vgt, Renderer(device="cpu"))
    assert isinstance(got, torch.Tensor) and got.shape == (80, 160, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert np.abs(got_u8.astype(np.int16) - want_u8.astype(np.int16)).max() <= 1
