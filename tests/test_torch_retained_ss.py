"""The port's retained-scene pan on the CPU with supersampled coverage (ss = 2
and 4: K2 form (d) on every bucket, sub-row offsets) and on randomized
scenes: each image against the port's direct end() of the translated scene
(vgtpu's tolerances, tests/test_retained.py and tests/test_retained_fuzz.py)
and against vgtpu's RetainedScene.render of the same recording (2e-4 against
its XLA pan; 2e-6 against its chunk-gather pan, Pallas in interpret mode).
The cases mirror the supersampled half of tests/test_retained.py (except the
A/B cases on vgtpu's two unported pan formulations) and
tests/test_retained_fuzz.py."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores
torch.set_num_threads(1)

import vgtpu as vgj  # noqa: E402
import vgtpu_torch as vgt  # noqa: E402
from tests.fontdata import FONT_DATA  # noqa: E402
from tests.test_torch_retained import (  # noqa: E402
    ATOL,
    ATOL_CG,
    ATOL_TEX,
    _img16,
    _new_image,
    _pattern_scene,
    bake,
    close,
    context,
    direct,
    scene,
)
from vgtpu_torch.raster.retained import RetainedScene  # noqa: E402

needs_font = pytest.mark.skipif(FONT_DATA is None, reason="no test font")


@pytest.fixture(scope="module")
def pairs():
    """The main scene baked at ss = 2 and 4 by the port and by vgtpu."""
    return {ss: (bake(vgt, scene, coverage_supersample=ss),
                 bake(vgj, scene, coverage_supersample=ss)) for ss in (2, 4)}


@pytest.mark.parametrize("ss", [2, 4])
@pytest.mark.parametrize("view", [(0, 0), (37, 5), (-45, -13), (128.5, 8)])
def test_ss_pan_matches_direct(pairs, ss, view):
    """A supersampled bake panned == the supersampled direct render of the
    translated scene (sub-row binning, the per-sub-row rule and the average
    commute with the residual shift)."""
    st, sj = pairs[ss]
    assert st.ss == ss
    got = st.render(*view)
    close(got, direct(scene, view, coverage_supersample=ss), ATOL, view)
    close(got, sj.render(*view), ATOL, view)


def test_ss_pan_matches_vgtpu_chunk_gather_pan(pairs):
    """At ss=2 vgtpu's chunk-gather pan sends every bucket through the
    sub-row composite (no resolve split), as the port's K2 form (d)."""
    st, sj = pairs[2]
    for view in [(37, 5), (-45, -13.5)]:
        close(st.render(*view), sj.render(*view, use_pallas=True), ATOL_CG, view)


def test_ss_subpixel_y_pan(pairs):
    """ss=4 scenes scroll at quarter-pixel y (whole sub-rows); other
    fractions are rejected."""
    st, _sj = pairs[4]
    close(st.render(5, -3.25), direct(scene, (5, -3.25), coverage_supersample=4), ATOL)
    with pytest.raises(ValueError, match="sub-rows"):
        st.render(0, 0.1)
    with pytest.raises(ValueError, match="sub-rows"):
        st.render_views([(0, 0), (0, 0.1)])


def test_ss_textured_views_match_render():
    """Supersampled scenes with sampling groups: the resample shifts by
    ry/ss OUTPUT pixels; render_views == render, and a view == the direct
    supersampled render."""
    draw = _pattern_scene(_new_image(_img16(7)))
    bg = (0.08, 0.08, 0.1, 1.0)
    s = bake(vgt, draw, bg=bg, coverage_supersample=2)
    assert s.samp_meta is not None and s.ss == 2
    views = [(0, 0), (41, 6), (-23, -11.5)]
    stack = s.render_views(views)
    sj = bake(vgj, draw, bg=bg, coverage_supersample=2)
    for k, view in enumerate(views):
        close(stack[k], s.render(*view), 2e-6, view)
        close(stack[k], sj.render(*view), ATOL, view)
    close(s.render(41, 6), direct(draw, (41, 6), bg=bg, coverage_supersample=2), ATOL)


@needs_font
def test_ss_text_matches_direct():
    """Text in a supersampled scene: the sampler reads the UNSCALED ops
    (quads live in output pixels) while coverage is y-scaled into sub-rows."""
    def draw(c, vg):
        f = vg.createFont(c, "sans", FONT_DATA, len(FONT_DATA), 0)
        cfg = vg.makeTextConfig(c, f, 20.0, vg.TextAlign.TopLeft,
                                vg.color4ub(240, 240, 200, 255))
        vg.text(c, cfg, 24, 40, "Supersampled pan")
        vg.beginPath(c)
        vg.rect(c, 20, 70, 160, 30)
        vg.fillPath(c, vg.color4ub(40, 80, 160, 255), vg.FillFlags.ConvexAA)

    s = bake(vgt, draw, coverage_supersample=2)
    assert s.samp_meta is not None and s.ss == 2
    for view in [(0, 0), (37, 5), (-19, -6.5)]:
        close(s.render(*view), direct(draw, view, coverage_supersample=2), ATOL_TEX, view)


# ---- randomized scenes (tests/test_retained_fuzz.py) ------------------------

FW, FH = 320, 128


def _make_recipe(rng):
    """A replayable list of draw steps (the direct render re-records them
    under a translate, so the scene is a pure function of the seed)."""
    steps = []
    n_clip = int(rng.integers(0, 2))
    for _ in range(int(rng.integers(5, 14))):
        r = rng.uniform()
        if r < 0.12 and n_clip:
            steps.append(("clip", rng.uniform(0.0, 1.0) < 0.7, rng.uniform(40, 280),
                          rng.uniform(20, 100), rng.uniform(15, 60)))
            n_clip -= 1
        elif r < 0.17:
            steps.append(("resetclip",))
        elif r < 0.27:
            if rng.uniform() < 0.5:
                steps.append(("scissor", rng.uniform(0, 80), rng.uniform(0, 50),
                              rng.uniform(60, 200), rng.uniform(40, 70)))
            else:
                steps.append(("noscissor",))
        elif r < 0.45:
            steps.append(("circle", rng.uniform(0, FW), rng.uniform(0, FH),
                          rng.uniform(5, 50), tuple(rng.integers(0, 256, 3)),
                          int(rng.integers(40, 256)), rng.uniform() < 0.7))
        elif r < 0.6:
            pts = rng.uniform(-20, FW + 20, (int(rng.integers(4, 10)), 2))
            pts[:, 1] = rng.uniform(-20, FH + 20, len(pts))
            steps.append(("poly", pts, tuple(rng.integers(0, 256, 3)),
                          int(rng.integers(60, 256)), rng.uniform() < 0.4))
        elif r < 0.75:
            steps.append(("grad", rng.uniform(0, FW), rng.uniform(0, FH),
                          rng.uniform(40, 160), rng.uniform(20, 60),
                          tuple(rng.integers(0, 256, 3)), tuple(rng.integers(0, 256, 3))))
        else:
            pts = rng.uniform(0, FW, (int(rng.integers(2, 6)), 2))
            pts[:, 1] = rng.uniform(0, FH, len(pts))
            steps.append(("stroke", pts, tuple(rng.integers(0, 256, 3)),
                          rng.uniform(0.5, 7.0)))
    steps.append(("resetclip",))
    return steps


def _draw(steps):
    def draw(ctx, vg):
        for s in steps:
            if s[0] == "clip":
                _k, inside, cx, cy, rr = s
                vg.beginClip(ctx, vg.ClipRule.In if inside else vg.ClipRule.Out)
                vg.beginPath(ctx)
                vg.circle(ctx, cx, cy, rr)
                vg.fillPath(ctx, vg.Colors.Black, vg.FillFlags.ConvexAA)
                vg.endClip(ctx)
            elif s[0] == "resetclip":
                vg.resetClip(ctx)
            elif s[0] == "scissor":
                vg.setScissor(ctx, *s[1:])
            elif s[0] == "noscissor":
                vg.resetScissor(ctx)
            elif s[0] == "circle":
                _k, cx, cy, rr, rgb, a, aa = s
                vg.beginPath(ctx)
                vg.circle(ctx, cx, cy, rr)
                vg.fillPath(ctx, vg.color4ub(*rgb, a),
                            vg.FillFlags.ConvexAA if aa else vg.FillFlags.Convex)
            elif s[0] == "poly":
                _k, pts, rgb, a, eo = s
                vg.beginPath(ctx)
                vg.polyline(ctx, pts)
                vg.closePath(ctx)
                vg.fillPath(ctx, vg.color4ub(*rgb, a),
                            vg.FillFlags.ConcaveEvenOddAA if eo
                            else vg.FillFlags.ConcaveNonZeroAA)
            elif s[0] == "grad":
                _k, x, y, w, h, c0, c1 = s
                g = vg.createLinearGradient(ctx, x, y, x + w, y + h,
                                            vg.color4ub(*c0, 255), vg.color4ub(*c1, 255))
                vg.beginPath(ctx)
                vg.rect(ctx, x, y, w, h)
                vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)
            elif s[0] == "stroke":
                _k, pts, rgb, w = s
                vg.beginPath(ctx)
                vg.polyline(ctx, pts)
                vg.strokePath(ctx, vg.color4ub(*rgb, 255), w, vg.StrokeFlags.RoundRoundAA)
    return draw


def _recolor(steps, rng):
    """Value-only mutation: new colours everywhere, the alpha class kept for
    NonZero solids (occlusion covers), free for even-odd fills."""
    out = []
    for s in steps:
        if s[0] == "circle":
            k, cx, cy, rr, _rgb, a, aa = s
            a2 = 255 if a == 255 else int(rng.integers(40, 255))
            out.append((k, cx, cy, rr, tuple(rng.integers(0, 256, 3)), a2, aa))
        elif s[0] == "poly":
            k, pts, _rgb, a, eo = s
            a2 = (int(rng.integers(60, 256)) if eo
                  else (255 if a == 255 else int(rng.integers(60, 255))))
            out.append((k, pts, tuple(rng.integers(0, 256, 3)), a2, eo))
        elif s[0] == "grad":
            k, x, y, w, h, _c0, _c1 = s
            out.append((k, x, y, w, h, tuple(rng.integers(0, 256, 3)),
                        tuple(rng.integers(0, 256, 3))))
        elif s[0] == "stroke":
            k, pts, _rgb, w = s
            out.append((k, pts, tuple(rng.integers(0, 256, 3)), w))
        else:
            out.append(s)
    return out


FBG = (0.15, 0.1, 0.2, 1.0)


def test_fuzz_pan_vs_direct():
    rng = np.random.default_rng(7)
    for trial in range(6):
        draw = _draw(_make_recipe(rng))
        s = bake(vgt, draw, bg=FBG, w=FW, h=FH)
        for _ in range(3):
            view = (int(rng.integers(-150, 300)), int(rng.integers(-60, 120)))
            close(s.render(*view), direct(draw, view, bg=FBG, w=FW, h=FH), 3e-4,
                  f"trial {trial} view {view}")


def test_fuzz_pan_vs_vgtpu():
    """Two randomized scenes against vgtpu's pan of the same recording."""
    rng = np.random.default_rng(29)
    for trial in range(2):
        draw = _draw(_make_recipe(rng))
        s, sj = bake(vgt, draw, bg=FBG, w=FW, h=FH), bake(vgj, draw, bg=FBG, w=FW, h=FH)
        for view in [(int(rng.integers(-150, 300)), int(rng.integers(-60, 120))),
                     (float(rng.uniform(-50, 150)), 0)]:
            close(s.render(*view), sj.render(*view), 3e-4, f"trial {trial} view {view}")


def test_fuzz_paint_update_vs_fresh_bake():
    """Random scenes + random value-only recolours: update_paint_values
    renders like a fresh bake of the recoloured scene, at integer and
    fractional-x views."""
    rng = np.random.default_rng(13)
    for trial in range(4):
        steps = _make_recipe(rng)
        ctx = context(vgt)
        vgt.begin(ctx, 0, FW, FH, 1.0)
        _draw(steps)(ctx, vgt)
        s = RetainedScene.bake(ctx, background=FBG)
        steps2 = _recolor(steps, rng)
        vgt.begin(ctx, 0, FW, FH, 1.0)
        _draw(steps2)(ctx, vgt)
        s.update_paint_values(ctx)
        want = bake(vgt, _draw(steps2), bg=FBG, w=FW, h=FH)
        for view in [(int(rng.integers(-100, 200)), int(rng.integers(-40, 80))),
                     (float(rng.uniform(-50, 150)), 0)]:
            close(s.render(*view), want.render(*view), 3e-4, f"trial {trial} view {view}")
