"""The reference (vgbench/reference) against vgtpu_torch run on the CPU
through its plain twins: the small scenes, the benchmark's frame and its
command-list and pan paths, in u8 levels (x 255) outside the threshold
ties.  Tolerances: CPU readings were 0.006-0.008 on the small
scenes and 0.08-0.23 on the frame at dpr 0.25; the limits sit a few times
above them and far under one level."""

import pytest

import vgtpu_torch as pv
from vgbench.check import level_gap
from vgbench.reference import vg as rv
from vgbench.reference.raster import render
from vgtpu_torch.fonts import UI_FONT
from vgtpu_torch.scenes import small

BG = (0.12, 0.12, 0.13, 1.0)
FONT = UI_FONT.read_bytes()


@pytest.mark.parametrize("ss", [1, 2])
@pytest.mark.parametrize("scene", ["draw_small_scene", "draw_feature_scene"])
def test_reference_matches_the_port_on_the_small_scenes(scene, ss):
    draw = getattr(small, scene)
    ctx = pv.createContext(pv.ContextConfig(coverage_supersample=ss), device="cpu")
    pv.begin(ctx, 0, small.WIDTH, small.HEIGHT, 1.0)
    draw(ctx, FONT)
    img = pv.end(ctx, background=BG)
    r = rv.createContext(FONT)
    rv.begin(r, 0, small.WIDTH, small.HEIGHT, 1.0)
    draw(r, FONT, vg=rv)
    ref, ties = render(r.ops, small.WIDTH, small.HEIGHT, r.image_map(), background=BG, ss=ss)
    assert level_gap(img, ref, ties) < 0.05
    assert int(ties.sum()) < 50          # the feature scene's non-AA triangle edges


@pytest.mark.parametrize("cell", ["tiger_ui_1080p.animate", "tiger_ui_1080p.scroll",
                                  "tiger_ui_1080p_ss2.app", "tiger_ui_1080p_ss2.scroll"])
def test_reference_matches_the_port_on_each_cells_frames(cell, small_cell):
    """Each cell's driver on the CPU at dpr 0.25: the program's frames
    (full path, command-list app, pan) against the reference's."""
    from vgbench import check, harness

    wl, cfg = small_cell(cell)
    env, driver = harness.make_driver(wl, cfg, harness_root(), 2**31 + 5, "cpu")
    for k in (0, 7):
        img = driver.frame(k, harness.Spans())
        ref, ties = check.reference_image(driver.reference(k), "cpu", ss=env.ss,
                                          background=env.background)
        assert level_gap(img, ref, ties) < 0.5


def test_a_cacheable_list_merges_no_draws(small_cell):
    """The port replays a Cacheable list draw by draw (no op merges into
    another), so the reference records the app cell's tiger unmerged: the
    merged recording is tens of levels away from the port's app frame."""
    from vgbench import check, harness
    from vgbench.scene import record_reference, tiger_at

    wl, cfg = small_cell("tiger_ui_1080p_ss2.app")
    cfg["context_config"]["coverage_supersample"] = 1
    env, driver = harness.make_driver(wl, cfg, harness_root(), 3, "cpu")
    img = driver.frame(0, harness.Spans())
    merged = record_reference(env, tiger_at(cfg), driver.t0)
    frame = (merged.ops, merged.fb_width, merged.fb_height, merged.image_map())
    ref, ties = check.reference_image(frame, "cpu", ss=1, background=env.background)
    assert level_gap(img, ref, ties) > 10
    ref, ties = check.reference_image(driver.reference(0), "cpu", ss=1,
                                      background=env.background)
    assert level_gap(img, ref, ties) < 0.5


def test_translated_ops_are_the_translated_drawing():
    """translate_ops moves geometry, scissors, quads and paints together:
    the frame drawn under translate(-dx, -dy) renders as its ops moved."""
    from vgbench.reference.ops import translate_ops

    def draw(dx, dy):
        r = rv.createContext(FONT)
        rv.begin(r, 0, small.WIDTH, small.HEIGHT, 1.0)
        rv.pushState(r)
        rv.transformTranslate(r, -dx, -dy)
        small.draw_small_scene(r, FONT, vg=rv)
        rv.popState(r)
        return r

    a, b = draw(0, 0), draw(37.25, 5)
    moved = translate_ops(a.ops, -37.25, -5)
    ia, ta = render(moved, small.WIDTH, small.HEIGHT, a.image_map(), background=BG)
    ib, tb = render(b.ops, small.WIDTH, small.HEIGHT, b.image_map(), background=BG)
    assert level_gap(ia, ib, ta | tb) < 0.05


def harness_root():
    import os

    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
