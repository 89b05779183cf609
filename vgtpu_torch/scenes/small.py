"""Small 512x256 scenes that exercise the composite's lanes.

draw_small_scene is vgtpu's `__graft_entry__._build_small_scene`: gradient,
solid fill + round stroke, a clip, an image-pattern fill (the texture lane)
and, when a font is given, text.  draw_feature_scene turns on every lane.
draw_resolve_scene adds what a supersampled frame's resolve split needs.
draw_pattern_panels (over make_pattern_images) adds image-pattern panels
to the 1080p frame for the device sampler.

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


def draw_resolve_scene(ctx, font_data: bytes | None = None, vg=None) -> None:
    """draw_feature_scene plus what the supersampled resolve split
    (raster/resolve.py) needs to reach every case: a scissored translucent
    fill outside any clip, whose chunkless interior tiles carry resolved
    backdrop rows that meet the x-scissor in K2's final-coverage form, an
    image pattern and vertex-coloured triangles in tiles without clip (the
    texture and triangle lanes of that form), and a dense zig-zag, an entry
    of several chunks (an XE row)."""
    if vg is None:
        import vgtpu_torch as vg

    draw_feature_scene(ctx, font_data, vg=vg)
    vg.setScissor(ctx, 37, 12, 301, 101)
    vg.beginPath(ctx)
    vg.rect(ctx, 20, 6, 470, 120)
    vg.fillPath(ctx, vg.color4ub(20, 40, 90, 120), vg.FillFlags.ConvexAA)
    vg.resetScissor(ctx)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (16, 16, 4), np.uint8)
    img[..., 3] = 255
    h_img = vg.createImage(ctx, 16, 16, 0, img)
    p = vg.createImagePattern(ctx, 330, 104, 32, 32, 0.0, h_img)
    vg.beginPath(ctx)
    vg.rect(ctx, 330, 104, 100, 30)
    vg.fillPath(ctx, p, vg.Colors.White, vg.FillFlags.ConvexAA)
    pos = np.array([[230, 104], [300, 112], [262, 138]], np.float32)
    cols = np.array([vg.Colors.Red, vg.Colors.Green, vg.Colors.Blue], np.uint32)
    vg.indexedTriList(ctx, pos, None, 3, cols, 3, np.array([0, 1, 2], np.uint16), 3, None)
    vg.beginPath(ctx)
    vg.moveTo(ctx, 210.0, 30.0)
    for i in range(60):
        vg.lineTo(ctx, 212.0 + i * 1.5, 30.0 + (7.0 if i % 2 else -7.0))
    vg.lineTo(ctx, 210.0, 50.0)
    vg.closePath(ctx)
    vg.fillPath(ctx, vg.color4ub(220, 120, 30, 255), vg.FillFlags.ConcaveNonZeroAA)


def draw_deep_chunk_scene(ctx, font_data: bytes | None = None, vg=None) -> None:
    """draw_small_scene plus four combs, concave paths of 14 to 30 teeth
    each inside one tile row: tiles that hold 29 to 61 edges of one path.
    With ContextConfig(chunk_pools=(2, 8, 48)) the native binner fills
    48-edge chunks, at ss = 2 in both a RES pool (one chunk of 40 edges)
    and a RAW pool (the 61-edge comb's entry spans two chunks)."""
    if vg is None:
        import vgtpu_torch as vg

    draw_small_scene(ctx, font_data, vg=vg)
    for x, y, teeth, w, rgba, flags in (
            (4.5, 1.0, 14, 4.0, (30, 160, 90, 200), vg.FillFlags.ConcaveNonZeroAA),
            (130.25, 9.5, 20, 5.0, (200, 60, 90, 180), vg.FillFlags.ConcaveEvenOddAA),
            (260.5, 17.25, 30, 4.0, (60, 60, 200, 220), vg.FillFlags.ConcaveNonZeroAA),
            (390.5, 100.25, 25, 4.5, (60, 160, 200, 220), vg.FillFlags.ConcaveNonZeroAA)):
        vg.beginPath(ctx)
        vg.moveTo(ctx, x, y + 6.0)
        for i in range(teeth):
            vg.lineTo(ctx, x + i * w + w / 2, y)
            vg.lineTo(ctx, x + (i + 1) * w, y + 6.0)
        vg.closePath(ctx)
        vg.fillPath(ctx, vg.color4ub(*rgba), flags)


DEEP_TILE_TEETH = 1_000   # draw_deep_tile_scene's comb: 2,001 edges in one tile


def draw_deep_tile_scene(ctx, font_data: bytes | None = None, vg=None) -> None:
    """A dense comb, one concave path of DEEP_TILE_TEETH teeth 0.12 px wide
    (2,001 edges) inside one 8x128 tile (columns 4-124, rows 1-7), over a
    rectangle and a triangle: with ContextConfig(chunk_pools=(2, 8, 2048))
    the comb's entry is one chunk of the 2,048-edge pool, deeper than the
    1,808 edges K1's shallow staging held (at ss = 2 its 16 sub-rows stay
    in one tile), while the other entries fill the 2- and 8-edge pools."""
    if vg is None:
        import vgtpu_torch as vg

    vg.beginPath(ctx)
    vg.rect(ctx, 8.5, 20.25, 300.0, 90.5)
    vg.fillPath(ctx, vg.color4ub(30, 160, 90, 255), vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.moveTo(ctx, 330.0, 30.0)
    vg.lineTo(ctx, 480.0, 60.0)
    vg.lineTo(ctx, 360.0, 200.0)
    vg.closePath(ctx)
    vg.fillPath(ctx, vg.color4ub(200, 60, 90, 200), vg.FillFlags.ConvexAA)
    w = 120.0 / DEEP_TILE_TEETH
    vg.beginPath(ctx)
    vg.moveTo(ctx, 4.0, 7.0)
    for i in range(DEEP_TILE_TEETH):
        vg.lineTo(ctx, 4.0 + i * w + w / 2, 1.0)
        vg.lineTo(ctx, 4.0 + (i + 1) * w, 7.0)
    vg.closePath(ctx)
    vg.fillPath(ctx, vg.color4ub(60, 60, 200, 220), vg.FillFlags.ConcaveNonZeroAA)


def make_pattern_images(ctx, seed: int = 20261016, vg=None) -> list:
    """The images draw_pattern_panels fills with: five seeded 64x64 RGBA
    images (random colour and alpha) in repeat and clamp modes with linear
    and nearest filters, created once per context so that re-recorded
    frames draw the same textures.  Returns (image handle, flags) pairs."""
    if vg is None:
        import vgtpu_torch as vg

    F = vg.ImageFlags
    rng = np.random.default_rng(seed)
    out = []
    for flags in (0, F.Clamp_UV, F.Filter_Nearest, F.Filter_Nearest | F.Clamp_UV, 0):
        img = rng.integers(0, 256, (64, 64, 4), np.uint8)
        out.append((vg.createImage(ctx, 64, 64, flags, img), flags))
    return out


def draw_pattern_panels(ctx, images, vg=None, x0: float = 1430.0,
                        y0: float = 40.0) -> None:
    """Image-pattern panels for the device sampler, right of the 1080p
    benchmark frame's UI: four axis-aligned patterns (the separable
    hat-weight products), one per (wrap, filter) pair of
    make_pattern_images, each on a rounded 220x220 panel with the pattern
    smaller than the panel (clamped edges and repeats both show), and a
    disc filled with a rotated pattern (the gather fallback)."""
    if vg is None:
        import vgtpu_torch as vg

    for i, (h, _flags) in enumerate(images[:4]):
        x = x0 + (i % 2) * 240.0
        y = y0 + (i // 2) * 240.0
        p = vg.createImagePattern(ctx, x + 30.3, y + 20.15, 96.37 + 16 * i, 80.29, 0.0, h)
        vg.beginPath(ctx)
        vg.roundedRect(ctx, x, y, 220.0, 220.0, 12.0)
        vg.fillPath(ctx, p, vg.color4ub(255, 255, 255, 230), vg.FillFlags.ConvexAA)
    p = vg.createImagePattern(ctx, x0 + 120.0, y0 + 500.0, 120.0, 90.0, 0.35, images[4][0])
    vg.beginPath(ctx)
    vg.circle(ctx, x0 + 230.0, y0 + 720.0, 200.0)
    vg.fillPath(ctx, p, vg.color4ub(255, 240, 220, 255), vg.FillFlags.ConvexAA)
