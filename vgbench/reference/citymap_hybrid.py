# Frozen copy of the satellite-hybrid style of vgtpu_torch/scenes/citymap.py
# (imagery, draw_hybrid) for the benchmark's plain reference: the same
# imagery generator and the same draw calls through the reference's
# recorder, over the city of reference/citymap.py, importing nothing of the
# program.
"""The satellite-hybrid style of the zoom-17 city map at dpr 2.

The city is reference/citymap.plan_city's from the seed.  Bottom to top:

  1. the imagery: one image a z17 tile (256 logical px), 512 x 512 RGBA8
     texels (@2x), linear filtering and both axes clamped, filled as a
     256 x 256 logical rect with its image pattern at the tile's origin,
     without antialiasing (each pixel shows one tile), so that one texel
     falls on one physical pixel at dpr 2;
  2. road casings of every class, then the fills minor to major, at the
     carto widths and colours, at opacity 0.7;
  3. the street names and place labels in white, without halo.

No land, landuse, water or building fills: the imagery shows them.  The
imagery is procedural (imagery()): two value noises over the region from
a generator of its own drawn from the seed, a ground cover that picks a
colour along a palette and a detail that scales its brightness."""

from __future__ import annotations

import numpy as np

from vgbench.reference import vg
from vgbench.reference.citymap import (
    CASING_EXTRA_PX,
    ROAD_CASING,
    ROAD_CLASSES,
    ROAD_FILL,
    _font,
    plan_city,
)
from vgbench.reference.core import xform_rotate

IMAGERY_TILE_PX = 256
IMAGERY_PX = 512
IMAGERY_FLAGS = vg.ImageFlags.Filter_Bilinear | vg.ImageFlags.Clamp_UV
IMAGERY_COVER_OCTAVES = (512, 256, 128, 64, 32)
IMAGERY_DETAIL_OCTAVES = (16, 8, 4, 2)
IMAGERY_PALETTE = ((46, 62, 38), (72, 88, 52), (104, 108, 80), (132, 124, 104),
                   (150, 146, 138), (112, 116, 120), (176, 170, 160))
ROAD_OPACITY = 0.7
HYBRID_LABEL = (255, 255, 255)


def _upsample2(a: np.ndarray) -> np.ndarray:
    """(h, w) -> (2h, 2w): along each axis a cell splits in two, each 3/4
    the cell and 1/4 its neighbour on that side (the edge cell its own)."""
    f = np.float32
    lo = np.concatenate([a[:, :1], a[:, :-1]], axis=1)
    hi = np.concatenate([a[:, 1:], a[:, -1:]], axis=1)
    x = np.empty((a.shape[0], 2 * a.shape[1]), np.float32)
    x[:, 0::2] = f(0.75) * a + f(0.25) * lo
    x[:, 1::2] = f(0.75) * a + f(0.25) * hi
    lo = np.concatenate([x[:1], x[:-1]], axis=0)
    hi = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.float32)
    out[0::2] = f(0.75) * x + f(0.25) * lo
    out[1::2] = f(0.75) * x + f(0.25) * hi
    return out


def _value_noise(rng, h: int, w: int, spacings) -> np.ndarray:
    """(h, w) float32 in [0, 1]: a uniform random lattice at the coarsest
    spacing, halved in spacing by _upsample2 down to one texel, with a
    lattice of half the amplitude added at each later spacing listed."""
    s = spacings[0]
    acc = rng.random((h // s, w // s), dtype=np.float32)
    amp = total = 1.0
    while s > 1:
        acc, s = _upsample2(acc), s // 2
        if s in spacings:
            amp *= 0.5
            acc += np.float32(amp) * rng.random(acc.shape, dtype=np.float32)
            total += amp
    return acc / np.float32(total)


def imagery(seed: int, cols: int, rows: int) -> list:
    """The region's imagery tiles, row-major, each (IMAGERY_PX, IMAGERY_PX, 4) uint8
    RGBA with alpha 255: the ground cover picks one of 256 colours along
    IMAGERY_PALETTE, the detail one of 64 brightness steps from 0.7 to
    1.3."""
    rng = np.random.default_rng([seed, 2])
    n = IMAGERY_PX
    H, W = rows * n, cols * n
    cover = _value_noise(rng, H, W, IMAGERY_COVER_OCTAVES)
    detail = _value_noise(rng, H, W, IMAGERY_DETAIL_OCTAVES)
    pal = np.asarray(IMAGERY_PALETTE, np.float64)
    ramp = np.stack([np.interp(np.arange(256) / 255.0, np.linspace(0.0, 1.0, len(pal)),
                               pal[:, ch]) for ch in range(3)], axis=1)
    lut = np.full((256, 64, 4), 255, np.uint8)
    lut[..., :3] = np.clip(np.rint(ramp[:, None, :] * (0.7 + 0.6 * np.arange(64) / 63.0)
                                   [None, :, None]), 0, 255)
    t = np.clip((cover - np.float32(0.5)) * np.float32(3.0) + np.float32(0.5), 0, 1)
    idx = np.rint(t * np.float32(255)).astype(np.intp) * 64
    idx += np.rint(detail * np.float32(63)).astype(np.intp)
    img = lut.reshape(-1, 4).view(np.uint32).reshape(-1)[idx].view(np.uint8).reshape(H, W, 4)
    return [np.ascontiguousarray(img[r * n:(r + 1) * n, c * n:(c + 1) * n])
            for r in range(rows) for c in range(cols)]


def draw_hybrid(ctx, seed: int, width: int = 2816, height: int = 2048, **stats) -> dict:
    """Draw the hybrid region on ctx (after begin), its imagery made from
    the seed, and return what was drawn."""
    city = plan_city(seed, width, height, **stats)
    st = city["stats"]
    cols, rows = -(-width // IMAGERY_TILE_PX), -(-height // IMAGERY_TILE_PX)
    tiles = imagery(seed, cols, rows)
    size = float(IMAGERY_TILE_PX)
    for k, data in enumerate(tiles):
        x, y = (k % cols) * size, (k // cols) * size
        img = vg.createImage(ctx, data.shape[1], data.shape[0], IMAGERY_FLAGS, data)
        pat = vg.createImagePattern(ctx, x, y, size, size, 0.0, img)
        vg.beginPath(ctx)
        vg.rect(ctx, x, y, size, size)
        vg.fillPath(ctx, pat, vg.Colors.White, vg.FillFlags.Convex)

    alpha = int(ROAD_OPACITY * 255 + 0.5)
    flags = vg.StrokeFlags.RoundRoundAA
    ways = city["ways"]
    by_class = [[pts.tolist() for c, pts, _s in ways if c == k]
                for k in range(len(ROAD_CLASSES))]
    for casing in (True, False):
        for k, (_name, width_px, _share) in enumerate(ROAD_CLASSES):
            c = ROAD_CASING[k] if casing else ROAD_FILL[k]
            col = vg.color4ub(c[0], c[1], c[2], alpha)
            w = width_px + (CASING_EXTRA_PX if casing else 0.0)
            for xy in by_class[k]:
                vg.beginPath(ctx)
                vg.moveTo(ctx, *xy[0])
                for x, y in xy[1:]:
                    vg.lineTo(ctx, x, y)
                vg.strokePath(ctx, col, w, flags)

    label = vg.color4ub(*HYBRID_LABEL, 255)
    font = _font(ctx)
    cfg = vg.makeTextConfig(ctx, font, st["street_font_px"], vg.TextAlign.MiddleCenter,
                            label)
    glyphs = 0
    for x, y, ang, name in city["street_labels"]:
        vg.pushState(ctx)
        vg.transformTranslate(ctx, x, y)
        vg.transformMult(ctx, xform_rotate(ang), vg.TransformOrder.Pre)
        vg.text(ctx, cfg, 0.0, 0.0, name)
        vg.popState(ctx)
        glyphs += len(name.replace(" ", ""))
    cfg = vg.makeTextConfig(ctx, font, st["place_font_px"], vg.TextAlign.MiddleCenter,
                            label)
    for x, y, name in city["place_labels"]:
        vg.text(ctx, cfg, x, y, name)
        glyphs += len(name.replace(" ", ""))
    return {"imagery_tiles": len(tiles), "ways": len(ways),
            "street_labels": len(city["street_labels"]),
            "place_labels": len(city["place_labels"]), "glyphs": glyphs}
