"""The city map scene (vgtpu_torch/scenes/citymap.py) on the CPU, at a
704 x 512 region: the published widths and densities, about a sixteenth of
the full region's features.

The port's ops equal those of the benchmark's plain reference generator
(vgbench/reference/citymap.py, drawn through the reference's recorder);
the port's bake and pan of three views stay within one u8 level of the
reference rasterizer on the translated ops, with the sampler's plain twin
taking the rotated labels; the bake honours and counts the depth cap; the
pan and sampler counters equal counts taken from the plan; the bake's
numpy binner and chunk repack equal vgtpu's."""

from __future__ import annotations

import warnings

import numpy as np
import pytest

import vgtpu_torch as vg
from vgbench.check import level_gap
from vgbench.reference import vg as rv
from vgbench.reference.citymap import draw_city as ref_draw_city
from vgbench.reference.ops import translate_ops as ref_translate_ops
from vgbench.reference.raster import render as ref_render
from vgtpu_torch.fonts import UI_FONT
from vgtpu_torch.raster import binning
from vgtpu_torch.raster.retained import RetainedScene, _repack_ladder
from vgtpu_torch.scenes.citymap import M_PER_PX, draw_city, region_km2

REGION = (704, 512)
VIEW = (480, 270)
BG = (242 / 255, 239 / 255, 233 / 255, 1.0)
SEEDS = (5, 2**31 + 77)
VIEWS = ((0.0, 0.0), (113.375, 97.0), (224.0, 242.0))
FONT_DATA = UI_FONT.read_bytes()      # the bytes the port's scene reads


def record(seed, cap=None):
    cfg = vg.ContextConfig(coverage_supersample=1, tile_w=128, tile_h=8,
                           device_sampling=True)
    if cap is not None:
        cfg.max_ops_per_tile_cap = cap
    ctx = vg.createContext(cfg, device="cpu")
    vg.begin(ctx, 0, *VIEW, 1.0)
    drawn = draw_city(ctx, seed, *REGION)
    return ctx, drawn


def record_reference(seed):
    r = rv.createContext(FONT_DATA)
    rv.begin(r, 0, *VIEW, 1.0)
    drawn = ref_draw_city(r, seed, *REGION)
    return r, drawn


@pytest.fixture(scope="module")
def city():
    """The port's recording and bake and the reference's recording of the
    first seed."""
    ctx, drawn = record(SEEDS[0])
    scene = RetainedScene.bake(ctx, *REGION, background=BG)
    r, _ = record_reference(SEEDS[0])
    return ctx, drawn, scene, r


def live_edges(e):
    """Edges of nonzero length: the reference's stroker repeats a point
    where a round join has fewer arc steps than its widest, the port's does
    not; both add nothing to coverage."""
    e = np.asarray(e, np.float32)
    return e[(e[:, 0] != e[:, 2]) | (e[:, 1] != e[:, 3])]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_records_the_reference_generators_ops(seed):
    ctx, drawn = record(seed)
    ctx._finalize_ops()
    r, ref_drawn = record_reference(seed)
    assert drawn == ref_drawn
    assert len(ctx.ops) == len(r.ops)
    for i, (p, q) in enumerate(zip(ctx.ops, r.ops)):
        assert (p.kind, p.paint_kind, p.fill_rule, p.aa, p.image_id, p.scissor) == (
            q.kind, q.paint_kind, q.fill_rule, q.aa, q.image_id, q.scissor), i
        np.testing.assert_array_equal(p.paint, q.paint)
        if q.tex_quads is not None:
            np.testing.assert_allclose(p.tex_quads, q.tex_quads, rtol=0, atol=1e-5)
            continue
        pe = np.concatenate(p.edges) if isinstance(p.edges, list) else p.edges
        a, b = live_edges(pe), live_edges(q.edges)
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_city_keeps_its_densities_and_widths(seed):
    """A region holds the features its area asks for: buildings up to
    2,500 a km2 (fewer where the blocks have no room: the 190 px river
    takes a third of this region), landuse and place labels at 16.83 a
    km2, a river of a vertex every 2.8 px of bank, islands, courtyards."""
    ctx, drawn = record(seed)
    km2 = region_km2(*REGION)
    assert abs(drawn["km2"] - km2) < 1e-12 and abs(M_PER_PX - 0.78575) < 1e-5
    assert 0.4 * 2500 * km2 <= drawn["buildings"] <= round(2500 * km2)
    assert drawn["landuse"] == drawn["place_labels"] == round(16.83 * km2)
    assert drawn["river_vertices"] >= 2 * REGION[0] / 2.8
    assert 1 <= drawn["islands"] <= 2 and drawn["courtyards"] > 0
    assert drawn["ways"] == sum(drawn["ways_by_class"].values())
    assert drawn["street_labels"] >= 1 and drawn["glyphs"] > 0


def test_the_pan_of_three_views_matches_the_reference(city):
    """Bake + pan against the reference rasterizer of the translated ops,
    within one u8 level outside the tie pixels; the scene's rotated labels
    are sampled by the plain twin (non-separable groups)."""
    _ctx, _drawn, scene, r = city
    assert any(not sep for _kind, sep, _flags in scene.samp_meta)
    for vx, vy in VIEWS:
        img = scene.render(vx, vy)
        ref, ties = ref_render(ref_translate_ops(r.ops, -vx, -vy), *VIEW, r.image_map(),
                               background=BG)
        assert level_gap(img, ref, ties) <= 1.0, (vx, vy)


def test_the_bake_honours_and_counts_the_depth_cap():
    """A bake over a lowered max_ops_per_tile_cap cuts the tiles deeper
    than it, warns, and counts them as depth_capped_tiles; at the default
    cap the map is cut nowhere."""
    ctx, _ = record(SEEDS[0])
    scene = RetainedScene.bake(ctx, *REGION, background=BG)
    depth = np.concatenate([(te[ids < scene.plan.ntx * scene.plan.nty] >= 0).sum(axis=1)
                            for te, ids, _f in scene.plan.tile_buckets])
    assert "depth_capped_tiles" not in ctx.profiler.counters
    assert scene.plan.stats.get("depth_capped_tiles", 0) == 0
    cap = int(np.percentile(depth, 90))
    ctx2, _ = record(SEEDS[0], cap=cap)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        capped = RetainedScene.bake(ctx2, *REGION, background=BG)
    assert any("exceeds cap" in str(x.message) for x in w)
    n = int((depth > cap).sum())
    assert n > 0
    assert ctx2.profiler.counters["depth_capped_tiles"] == n
    assert capped.plan.stats["depth_capped_tiles"] == n
    assert max(int((te >= 0).sum(axis=1).max())
               for te, _i, _f in capped.plan.tile_buckets) <= cap


def test_the_pan_counters_equal_the_plan(city):
    """Each view adds pan_tiles, pan_entries and pan_edges over the scene
    tiles its window reaches, counted by hand from the baked plan: the
    bucket rows of those tiles, their entries, and the pool slots of the
    chunks whose entry lies on one of them (padding included); each view's
    counts are below the whole scene's.  sample_rotated_pairs counts the
    (entry, quad) pairs of the non-separable groups in the sampler's tile
    index, sample_footprint_px the (pair, pixel) slots of its footprints at
    no shift: more than none, under a fortieth of every pair's whole tile
    (~8 x 9 px glyph quads in 8 x 128 tiles)."""
    ctx, _drawn, scene, _r = city
    plan = scene.plan
    nt = plan.ntx * plan.nty
    tw, th = plan.tile_w, plan.tile_h
    cols, rows = -(-VIEW[0] // tw), -(-VIEW[1] // th)

    def window(vx, vy):
        """Whether each flat scene tile id lies in the view's window."""
        tx0 = int(np.floor((vx + scene.off[0]) / tw))
        ty0 = int(np.floor((vy + scene.off[1]) / th))
        tile = np.arange(nt + 1)
        tx, ty = tile % plan.ntx, tile // plan.ntx
        return ((tx >= tx0) & (tx < tx0 + cols) & (ty >= ty0) & (ty < ty0 + rows)
                & (tile < nt))

    def counts(inside):
        tiles = entries = 0
        for te, ids, _f in plan.tile_buckets:
            for row, tid in zip(te, ids):
                if inside[tid]:
                    tiles += 1
                    entries += int((row >= 0).sum())
        edges = sum(int(inside[plan.entry_tile[cent]].sum()) * ce.shape[1]
                    for ce, cent in plan.chunk_pools)
        return tiles, entries, edges

    whole = counts(np.arange(nt + 1) < nt)
    assert whole[2] == scene.d["edges"].shape[0]
    want = np.zeros(3, np.int64)
    for vx, vy in VIEWS[:2]:
        got = counts(window(vx, vy))
        assert all(0 < g < w for g, w in zip(got, whole)), (got, whole)
        want += got
    g = scene.d["samp"]
    pairs = g.words[g.at["pairs"]:].view(-1, 2).numpy()
    rotated = sum(int((pairs[:, 1] == k).sum())
                  for k, (_kind, sep, _fl) in enumerate(g.meta) if not sep)
    assert rotated > 0
    prof = ctx.profiler
    prof.reset()
    for vx, vy in VIEWS[:2]:
        scene.render(vx, vy)
    c = prof.counters
    assert (c["pan_tiles"], c["pan_entries"], c["pan_edges"]) == tuple(want)
    assert c["sample_rotated_pairs"] == 2 * rotated
    assert c["sample_footprint_px"] == 2 * g.footprint_px
    assert 0 < 40 * g.footprint_px < g.n_pairs * th * tw
    assert want[1] > 10 * want[0]


def plans_equal(a, b):
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "chunk_pools":
            for (c1, e1), (c2, e2) in zip(x, y, strict=True):
                np.testing.assert_array_equal(c1, c2)
                np.testing.assert_array_equal(e1, e2)
                assert c1.dtype == c2.dtype and e1.dtype == e2.dtype
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def scene_ops(which):
    from vgtpu_torch.scenes import small
    from vgtpu_torch.scenes.demo_ui import draw_demo_ui
    from vgtpu_torch.scenes.tiger import draw_tiger

    draw, w, h = {
        "empty": (lambda c: None, 256, 64),
        "city": (lambda c: draw_city(c, 9, *REGION), *REGION),
        "feature": (lambda c: small.draw_feature_scene(c, FONT_DATA), small.WIDTH, small.HEIGHT),
        "tiger_ui": (lambda c: (draw_tiger(c, 20, 60, 1.06),
                                draw_demo_ui(c, 0.3, 980, 40)), 1920, 1080),
    }[which]
    ctx = vg.createContext(device="cpu")
    vg.begin(ctx, 0, w, h, 1.0)
    draw(ctx)
    ctx._finalize_ops()
    ops = binning.expand_tri_batches(ctx.ops)
    for op in ops:
        if isinstance(op.edges, list):
            op.edges = np.concatenate(op.edges, axis=0)
    return ops, w, h


@pytest.mark.parametrize("pan_margin", [False, True])
@pytest.mark.parametrize("which", ["empty", "city", "feature", "tiger_ui"])
def test_the_batched_binner_and_repack_equal_their_per_op_forms(which, pan_margin):
    """The port's numpy binner (every edge op in one vectorised pass) gives
    the plan of vgtpu's bin_frame_numpy (one pass an op) array for array,
    over edges, clip shapes and commits, scissors, textured quads and
    triangles; the port's vectorised repack gives the pools of vgtpu's
    per-chunk _repack_ladder."""
    from vgtpu.raster.binning import bin_frame_numpy as reference_binner
    from vgtpu.raster.retained import _repack_ladder as reference_repack

    ops, w, h = scene_ops(which)
    for th, tw in ((8, 128), (16, 64)):
        a = reference_binner(ops, w + 37, h + 11, tile_h=th, tile_w=tw,
                             pan_margin=pan_margin)
        b = binning.bin_frame_numpy(ops, w + 37, h + 11, tile_h=th, tile_w=tw,
                                    pan_margin=pan_margin)
        plans_equal(a, b)
    ne = b.entry_backdrop.shape[0]
    for ladder in ((2, 4, 8, 24), (4, 16)):
        for (c1, e1), (c2, e2) in zip(reference_repack(b.chunk_pools, ne, ladder),
                                      _repack_ladder(b.chunk_pools, ne, ladder), strict=True):
            np.testing.assert_array_equal(c1, c2)
            np.testing.assert_array_equal(e1, e2)
