"""Small 512x256 scenes that exercise the composite's lanes.

draw_small_scene is vgtpu's `__graft_entry__._build_small_scene`: gradient,
solid fill + round stroke, a clip, an image-pattern fill (the texture lane)
and, when a font is given, text.  draw_feature_scene turns on every lane.

`vg` is the module whose vg:: surface draws them (vgtpu_torch by default),
so tests can record the identical scene through vgtpu and the port."""

from __future__ import annotations

import numpy as np

WIDTH, HEIGHT = 512, 256


def draw_small_scene(ctx, font_data: bytes | None = None, vg=None) -> None:
    if vg is None:
        import vgtpu_torch as vg

    g = vg.createLinearGradient(ctx, 20, 20, 200, 120, vg.Colors.Red, vg.Colors.Blue)
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 20, 20, 180, 100, 20)
    vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.circle(ctx, 300, 80, 50)
    vg.fillPath(ctx, vg.color4ub(255, 200, 0, 255), vg.FillFlags.ConvexAA)
    vg.strokePath(ctx, vg.Colors.Black, 4.0, vg.StrokeFlags.RoundRoundAA)
    vg.beginClip(ctx, vg.ClipRule.In)
    vg.beginPath(ctx)
    vg.circle(ctx, 420, 160, 60)
    vg.fillPath(ctx, vg.Colors.Black, vg.FillFlags.Convex)
    vg.endClip(ctx)
    vg.beginPath(ctx)
    vg.rect(ctx, 360, 100, 140, 120)
    vg.fillPath(ctx, vg.color4ub(30, 160, 90, 255), vg.FillFlags.ConvexAA)
    vg.resetClip(ctx)
    rng = np.random.default_rng(11)
    img = rng.integers(0, 255, (32, 32, 4), np.uint8)
    img[..., 3] = 255
    h_img = vg.createImage(ctx, 32, 32, 0, img)
    p = vg.createImagePattern(ctx, 220, 150, 64, 64, 0.0, h_img)
    vg.beginPath(ctx)
    vg.rect(ctx, 220, 150, 120, 90)
    vg.fillPath(ctx, p, vg.Colors.White, vg.FillFlags.ConvexAA)
    if font_data is not None:
        f = vg.createFont(ctx, "sans", font_data, len(font_data), 0)
        cfg = vg.makeTextConfig(ctx, f, 24.0, vg.TextAlign.BaselineLeft,
                                vg.color4ub(240, 240, 255, 255))
        vg.text(ctx, cfg, 30, 230, "dryrun")


def draw_feature_scene(ctx, font_data: bytes | None = None, vg=None) -> None:
    """vgtpu's tests/test_composite_pallas.py::_scene_full plus text: every
    lane of the composite — gradient, triangle colours, even-odd, clip,
    non-AA, scissor and (with a font) textured quads."""
    if vg is None:
        import vgtpu_torch as vg

    g = vg.createLinearGradient(ctx, 10, 10, 200, 150, vg.Colors.Red, vg.Colors.Blue)
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 10, 10, 190, 140, 25)
    vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.circle(ctx, 300, 80, 60)
    vg.fillPath(ctx, vg.color4ub(255, 200, 0, 255), vg.FillFlags.ConvexAA)
    vg.strokePath(ctx, vg.Colors.Black, 5.0, vg.StrokeFlags.RoundRoundAA)
    ang = -np.pi / 2 + np.arange(5) * (4 * np.pi / 5)
    vg.beginPath(ctx)
    vg.moveTo(ctx, 420 + 50 * np.cos(ang[0]), 80 + 50 * np.sin(ang[0]))
    for a in ang[1:]:
        vg.lineTo(ctx, 420 + 50 * np.cos(a), 80 + 50 * np.sin(a))
    vg.closePath(ctx)
    vg.fillPath(ctx, vg.color4ub(40, 220, 120, 200), vg.FillFlags.ConcaveEvenOddAA)
    vg.beginClip(ctx, vg.ClipRule.In)
    vg.beginPath(ctx)
    vg.circle(ctx, 140, 200, 55)
    vg.fillPath(ctx, vg.Colors.Black, vg.FillFlags.Convex)
    vg.endClip(ctx)
    vg.setScissor(ctx, 60, 150, 400, 100)
    vg.beginPath(ctx)
    vg.rect(ctx, 60, 150, 200, 100)
    vg.fillPath(ctx, vg.color4ub(30, 120, 230, 255), vg.FillFlags.Convex)
    vg.resetScissor(ctx)
    vg.resetClip(ctx)
    pos = np.array([[330, 160], [470, 170], [400, 250]], np.float32)
    cols = np.array([vg.Colors.Red, vg.Colors.Green, vg.Colors.Blue], np.uint32)
    vg.indexedTriList(ctx, pos, None, 3, cols, 3, np.array([0, 1, 2], np.uint16), 3, None)
    if font_data is not None:
        f = vg.createFont(ctx, "sans", font_data, len(font_data), 0)
        cfg = vg.makeTextConfig(ctx, f, 22.0, vg.TextAlign.BaselineLeft, vg.Colors.White)
        vg.text(ctx, cfg, 270, 235, "composite")
