"""The satellite-hybrid city map (vgtpu_torch/scenes/citymap.draw_hybrid) on
the CPU, at devicePixelRatio 2 over a 768 x 512 logical region (3 x 2
imagery tiles of 512 x 512 texels, 1536 x 1024 physical pixels) and a
320 x 180 logical view (640 x 360 physical).

draw_city's ops and counts at seed 1 are those of the configuration
citymap_z17 and of the benchmark's frozen reference generator; the
imagery generator and the hybrid's ops equal the reference copy's
(vgbench/reference/citymap_hybrid.py); the bake and pan stay within one
u8 level of the reference rasterizer at a fractional x, at the region's
far edge and at a view across an imagery corner, with S1's plain twin
sampling the pattern fills; the resample counts the scene's pattern
tiles, the bake its textures' bytes and its bake.textures stage."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

import vgtpu_torch as vg
from vgbench.check import level_gap
from vgbench.reference import vg as rv
from vgbench.reference.citymap import draw_city as ref_draw_city
from vgbench.reference.citymap_hybrid import draw_hybrid as ref_draw_hybrid
from vgbench.reference.citymap_hybrid import imagery as ref_imagery
from vgbench.reference.ops import translate_ops as ref_translate_ops
from vgbench.reference.raster import render as ref_render
from vgtpu_torch.fonts import UI_FONT
from vgtpu_torch.raster.binning import P_IMAGE
from vgtpu_torch.raster.retained import RetainedScene
from vgtpu_torch.scenes.citymap import IMAGERY_PX, draw_city, draw_hybrid, imagery

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGION = (768, 512)                 # logical px: 3 x 2 z17 tiles
DPR = 2.0
VIEW = (320, 180)                   # logical px
VIEW_PX = (640, 360)
BG = (0.0, 0.0, 0.0, 1.0)
SEED = 3
FONT_DATA = UI_FONT.read_bytes()    # the bytes the port's scene reads
VIEWS = {
    "fractional_x": (113.375, 97.0),
    "far_edge": (896.0, 664.0),      # the region less the view, physical px
    "imagery_corner": (300.625, 400.0),
}


def config(name):
    with open(os.path.join(ROOT, "vgbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def hybrid_context():
    cfg = config("citymap_z17_hybrid2x")
    ctx = vg.createContext(vg.ContextConfig(**cfg["context_config"]), device="cpu")
    vg.begin(ctx, 0, *VIEW, DPR)
    return ctx, cfg


def assert_same_ops(port_ops, ref_ops):
    assert len(port_ops) == len(ref_ops)
    for i, (p, q) in enumerate(zip(port_ops, ref_ops)):
        assert (p.kind, p.paint_kind, p.fill_rule, p.aa, p.image_id, p.scissor) == (
            q.kind, q.paint_kind, q.fill_rule, q.aa, q.image_id, q.scissor), i
        np.testing.assert_array_equal(p.paint, q.paint)
        if q.tex_quads is not None:
            np.testing.assert_allclose(p.tex_quads, q.tex_quads, rtol=0, atol=1e-5)
            continue
        pe = np.concatenate(p.edges) if isinstance(p.edges, list) else p.edges
        pe, qe = np.asarray(pe, np.float32), np.asarray(q.edges, np.float32)
        # the reference's stroker repeats a point where a round join has
        # fewer arc steps than its widest; such edges add nothing
        pe = pe[(pe[:, 0] != pe[:, 2]) | (pe[:, 1] != pe[:, 3])]
        qe = qe[(qe[:, 0] != qe[:, 2]) | (qe[:, 1] != qe[:, 3])]
        assert pe.shape == qe.shape, i
        np.testing.assert_allclose(pe, qe, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def hybrid():
    """The port's recording and bake, and the reference's recording."""
    ctx, cfg = hybrid_context()
    drawn = draw_hybrid(ctx, SEED, *REGION, **cfg["city"])
    scene = RetainedScene.bake(ctx, *(round(v * DPR) for v in REGION), background=BG)
    r = rv.createContext(FONT_DATA)
    rv.begin(r, 0, *VIEW, DPR)
    ref_drawn = ref_draw_hybrid(r, SEED, *REGION, **cfg["city"])
    return ctx, drawn, scene, r, ref_drawn


def test_draw_city_keeps_its_ops_and_counts_at_seed_1():
    """draw_city's default ops at seed 1 over the full 2816 x 2048 region
    are the frozen reference generator's, and what it reports, and its op
    count, are citymap_z17.json's drawn_at_seed_1 (entries and the deepest
    tile are the bake's, which this leaves out)."""
    cfg = config("citymap_z17")
    ctx = vg.createContext(vg.ContextConfig(**cfg["context_config"]), device="cpu")
    vg.begin(ctx, 0, cfg["width"], cfg["height"], cfg["dpr"])
    drawn = draw_city(ctx, 1, *cfg["region"], **cfg["city"])
    ctx._finalize_ops()
    want = cfg["drawn_at_seed_1"]
    assert len(ctx.ops) == want["ops"]
    for key, value in want.items():
        if key in ("ops", "entries", "deepest_tile"):
            continue
        if key == "road_km":
            assert round(drawn[key], 2) == value
        else:
            assert drawn[key] == value, key
    r = rv.createContext(FONT_DATA)
    rv.begin(r, 0, cfg["width"], cfg["height"], cfg["dpr"])
    ref_draw_city(r, 1, *cfg["region"], **cfg["city"])
    assert_same_ops(ctx.ops, r.ops)


@pytest.mark.parametrize("seed", [7, 2**31 + 77])
def test_the_imagery_generator_equals_the_reference_copy(seed):
    """Bit for bit, for a 3 x 2 grid: opaque RGBA8 tiles of IMAGERY_PX
    texels that join (the noise runs over the whole region) and differ
    between seeds."""
    tiles = imagery(seed, 3, 2)
    ref = ref_imagery(seed, 3, 2)
    assert len(tiles) == len(ref) == 6
    for a, b in zip(tiles, ref):
        assert a.shape == (IMAGERY_PX, IMAGERY_PX, 4) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        assert (a[..., 3] == 255).all() and a[..., :3].std() > 5
    seam = np.abs(tiles[0][:, -1, :3].astype(int) - tiles[1][:, 0, :3].astype(int))
    inside = np.abs(np.diff(tiles[0][:, -2:, :3].astype(int), axis=1))[:, 0]
    assert seam.mean() < 3 * inside.mean() + 1
    assert not np.array_equal(tiles[0], imagery(seed + 1, 3, 2)[0])


def test_the_hybrid_records_the_reference_copys_ops(hybrid):
    """One unantialiased image-pattern rect a z17 tile, then the roads at
    alpha 179 and the white labels: the reference copy's ops, images and
    counts."""
    ctx, drawn, _scene, r, ref_drawn = hybrid
    assert drawn["imagery_tiles"] == 6 and drawn["ways"] > 10 and drawn["street_labels"] > 3
    assert {k: drawn[k] for k in ref_drawn} == ref_drawn
    assert_same_ops(ctx.ops, r.ops)
    image_ops = [op for op in ctx.ops if op.paint_kind == P_IMAGE]
    assert len(image_ops) == 6 and not any(op.aa for op in image_ops)
    assert {round(float(op.paint[13]) * 255) for op in ctx.ops[6:]
            if op.tex_quads is None} == {179}
    for op in image_ops:
        np.testing.assert_array_equal(ctx.images[op.image_id].data,
                                      r.images[op.image_id][0])


@pytest.mark.parametrize("view", list(VIEWS))
def test_the_pan_matches_the_reference(hybrid, view):
    """Bake + pan at dpr 2 against the reference rasterizer of the
    translated ops, within one u8 level outside the tie pixels."""
    _ctx, _drawn, scene, r, _ref_drawn = hybrid
    vx, vy = VIEWS[view]
    img = scene.render(vx, vy)
    assert tuple(img.shape) == (VIEW_PX[1], VIEW_PX[0], 4)
    ref, ties = ref_render(ref_translate_ops(r.ops, -vx, -vy), *VIEW_PX, r.image_map(),
                           background=BG)
    assert level_gap(img, ref, ties) <= 1.0, view
    assert int(ties.sum()) < VIEW_PX[1] * 4


def test_the_resample_and_bake_count_the_pattern_tiles_and_textures(hybrid):
    """sample_pattern_tiles adds, each view, the colour tiles of the scene's
    image-pattern entries (each entry its own tile: every tile of the
    region holds one, tiles on the seams two, and the pan margin adds a
    column on either side of an image and a row below it); texture_bytes is the float32 bytes of the six images and the
    glyph atlas on the device; bake.textures is a stage of the bake."""
    ctx, _drawn, scene, _r, _ref_drawn = hybrid
    plan = scene.plan
    n = plan.n_real_entries
    pattern = plan.entry_paint_kind[:n] == P_IMAGE
    tiles = np.unique(plan.entry_color_tile[:n][pattern])
    assert len(tiles) == int(pattern.sum())
    grid = (REGION[0] * 2 // plan.tile_w) * (REGION[1] * 2 // plan.tile_h)
    assert grid < len(tiles) <= 6 * (IMAGERY_PX // plan.tile_w + 2) * (
        IMAGERY_PX // plan.tile_h + 1)
    g = scene.d["samp"]
    assert g.pattern_tiles == len(tiles)
    texs = {t.data_ptr(): t for t in g.texs}
    assert ctx.profiler.counters["texture_bytes"] == sum(
        t.numel() * t.element_size() for t in texs.values())
    assert sum(t.shape == (IMAGERY_PX, IMAGERY_PX, 4) for t in texs.values()) == 6
    assert ctx.profiler.times_ms["bake.textures"] > 0
    ctx.profiler.reset()
    for vx, vy in list(VIEWS.values())[:2]:
        scene.render(vx, vy)
    assert ctx.profiler.counters["sample_pattern_tiles"] == 2 * len(tiles)
