"""The retained pan over its view window (vgtpu_torch/raster/retained.py) on
the CPU, plain route: K1's twin computes only the chunks of the scene
tiles the view reaches and K2's twin composites only their bucket rows,
straight into the view's output.  Every image is held, bit for bit, to
the whole-scene route: every chunk's coverage, every scene tile
composited into a framebuffer (ops/composite.frame_fb without a window),
then the window copied out of it (whole_scene_view below).  Views inside
the scene, on each of its four edges, partly off it on every side, wholly
off it and at fractional x; at ss = 1 and 2, on a textured scene with
text, and with the deep chunk pools; through render, render_tiles,
render_views and after update_paint_values.  A last case fills every
coverage row the window skips with NaN: no skipped row is read."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores
torch.set_num_threads(1)

import vgtpu_torch as vgt  # noqa: E402
from tests.test_torch_retained import (  # noqa: E402
    BG,
    COLORS_A,
    COLORS_B,
    H,
    W,
    _img16,
    _new_image,
    _pattern_scene,
    _scene_colored,
    bake,
    context,
    scene,
)
from vgtpu_torch.fonts import UI_FONT  # noqa: E402
from vgtpu_torch.ops import coverage as coverage_ops  # noqa: E402
from vgtpu_torch.ops.composite import (  # noqa: E402
    composite_bucket_into_torch,
    frame_fb,
)
from vgtpu_torch.ops.coverage import ViewWindow, cov_all_torch  # noqa: E402
from vgtpu_torch.raster.retained import RetainedScene  # noqa: E402

FONT = UI_FONT.read_bytes()
VIEWS = ("inside", "left_edge", "right_edge", "top_edge", "bottom_edge",
         "off_left", "off_right", "off_top", "off_bottom", "off_scene",
         "fractional_x")
SCENES = ("ss1", "ss2", "textured", "pools48", "pools2048")


def textured(ctx, vg):
    """An image pattern, a solid and a line of text: every view resamples
    the pattern and the glyph quads."""
    _pattern_scene(_new_image(_img16()))(ctx, vg)
    f = vg.createFont(ctx, "sans", FONT, len(FONT), 0)
    cfg = vg.makeTextConfig(ctx, f, 20.0, vg.TextAlign.TopLeft,
                            vg.color4ub(240, 240, 200, 255))
    vg.text(ctx, cfg, 24, 118, "Pan me exactly!")


def deep(ctx, vg):
    """tests/test_torch_retained.py::test_pan_with_deep_chunk_pools' scene:
    a 400-edge star over the main scene."""
    vg.beginPath(ctx)
    t = np.linspace(0, 2 * np.pi, 400, endpoint=False)
    r = 60 + 25 * np.sin(9 * t)
    vg.polyline(ctx, np.stack([190 + r * np.cos(t), 80 + 0.9 * r * np.sin(t)], 1))
    vg.closePath(ctx)
    vg.fillPath(ctx, vg.color4ub(220, 90, 40, 230), vg.FillFlags.ConcaveNonZeroAA)
    scene(ctx, vg)


BAKES = {
    "ss1": lambda: bake(vgt, scene),
    "ss2": lambda: bake(vgt, scene, coverage_supersample=2),
    "textured": lambda: bake(vgt, textured, bg=(0.08, 0.08, 0.1, 1.0)),
    "pools48": lambda: bake(vgt, deep, chunk_pools=(2, 8, 48)),
    "pools2048": lambda: bake(vgt, deep, chunk_pools=(2, 8, 2048)),
}


@pytest.fixture(scope="module")
def scenes():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = BAKES[name]()
        return cache[name]
    return get


def view_at(s: RetainedScene, name: str) -> tuple:
    """The named view of a scene, in view pixels: the scene's grid spans
    x in [x0, x1) and y in [y0, y1)."""
    tw, th = s.tile_w, s.tile_h // s.ss
    x0, y0 = -s.off[0], -s.off[1]
    x1, y1 = s.plan.ntx * tw + x0, s.plan.nty * th + y0
    return {
        "inside": (x0 + tw + 7, y0 + 3),
        "left_edge": (x0, y0 + 3),
        "right_edge": (x1 - W, y0 + 3),
        "top_edge": (x0 + 50, y0),
        "bottom_edge": (x0 + 50, y1 - H),
        "off_left": (x0 - 150, y0 + 3),
        "off_right": (x1 - W + 150, y0 + 3),
        "off_top": (x0 + 50, y0 - 37),
        "off_bottom": (x0 + 50, y1 - H + 37),
        "off_scene": (x1 + 300, y1 + 50),
        "fractional_x": (x0 + 200.625, y0 + 5),
    }[name]


def epilogue(fb, background, vx, vy, *, NTX, NTY, ntx_o, nty_o, th_out, tw,
             out_w, out_h, tiles_only):
    """The window of a whole-scene framebuffer: output tile (ty, tx) shows
    scene tile (ty+vy, tx+vx), the background where that lies off the
    scene (the pan's epilogue before the view window)."""
    bg = torch.tensor(background, dtype=torch.float32)
    grid = fb.view(NTY, NTX, th_out, tw, 4)
    y0, y1 = max(vy, 0), min(vy + nty_o, NTY)
    x0, x1 = max(vx, 0), min(vx + ntx_o, NTX)
    if tiles_only:
        out = bg.expand(nty_o, ntx_o, th_out, tw, 4).clone()
        if y0 < y1 and x0 < x1:
            out[y0 - vy : y1 - vy, x0 - vx : x1 - vx] = grid[y0:y1, x0:x1]
        return out.view(nty_o * ntx_o, th_out, tw, 4)
    img = bg.expand(nty_o, th_out, ntx_o, tw, 4).clone()
    if y0 < y1 and x0 < x1:
        img[y0 - vy : y1 - vy, :, x0 - vx : x1 - vx] = grid[y0:y1, x0:x1].permute(0, 2, 1, 3, 4)
    return img.view(nty_o * th_out, ntx_o * tw, 4)[:out_h, :out_w].contiguous()


def whole_scene_view(s: RetainedScene, view, background=None, tiles_only=False):
    """The view through the whole-scene route: every chunk's coverage
    (no window), frame_fb over every scene tile, then the window copy."""
    background = s.background if background is None else tuple(background)
    vx, vy, rx, ry = s._offsets(*view)
    cov, ct_flat = s._pan_inputs(rx, ry, None, plain=True)
    d, plan = s.d, s.plan
    th_out = s.tile_h // s.ss
    fb = frame_fb(cov, d["bucket_ids"], d["bucket_pteb"], d["bucket_params"],
                  d["bucket_ctile"], ct_flat, background, tile_h=s.tile_h,
                  tile_w=s.tile_w, num_tiles=plan.ntx * plan.nty,
                  bucket_flags=d["bucket_flags"], ss=s.ss,
                  bucket_fn=composite_bucket_into_torch)
    return epilogue(fb, background, vx, vy, NTX=plan.ntx, NTY=plan.nty,
                    ntx_o=-(-s.out_w // s.tile_w), nty_o=-(-s.out_h // th_out),
                    th_out=th_out, tw=s.tile_w, out_w=s.out_w, out_h=s.out_h,
                    tiles_only=tiles_only)


def equal(got, want, what):
    assert got.shape == want.shape, what
    assert torch.equal(got, want), (what, float((got - want).abs().max()))


@pytest.mark.parametrize("view", VIEWS)
@pytest.mark.parametrize("which", SCENES)
def test_windowed_render_equals_the_whole_scene_route(scenes, which, view):
    s = scenes(which)
    v = view_at(s, view)
    got = s.render(*v, use_pallas=False)
    assert got.shape == (H, W, 4)
    equal(got, whole_scene_view(s, v), (which, view, v))
    equal(s.render(*v), got, (which, view, "dispatch"))


@pytest.mark.parametrize("which", SCENES)
def test_windowed_render_tiles_equal_the_whole_scene_route(scenes, which):
    """render_tiles, the cached-list layer's form: the (nty*ntx, th, tw,
    4) output tile grid, off-scene tiles in the given background."""
    s = scenes(which)
    layer_bg = (0.0, 0.5, 0.0, 1.0)
    for name in ("inside", "off_right", "off_bottom", "off_scene", "fractional_x"):
        v = view_at(s, name)
        for bg in (None, layer_bg):
            got = s.render_tiles(*v, background=bg, use_pallas=False)
            equal(got, whole_scene_view(s, v, bg, tiles_only=True), (which, name, bg))


@pytest.mark.parametrize("which", SCENES)
def test_windowed_render_views_equal_the_whole_scene_route(scenes, which):
    s = scenes(which)
    views = [view_at(s, name) for name in VIEWS]
    stack = s.render_views(views, use_pallas=False)
    assert stack.shape == (len(views), H, W, 4)
    for k, v in enumerate(views):
        equal(stack[k], whole_scene_view(s, v), (which, v))


def test_windowed_views_after_update_paint_values():
    """Patched paint values reach the windowed pan as the whole-scene
    route renders them, at views inside, across and off the scene."""
    ctx = context(vgt)
    vgt.begin(ctx, 0, W, H, 1.0)
    _scene_colored(ctx, vgt, **COLORS_A)
    s = RetainedScene.bake(ctx, background=BG)
    names = ("inside", "right_edge", "off_left", "off_bottom", "fractional_x")
    before = [s.render(*view_at(s, n)).clone() for n in names]
    vgt.begin(ctx, 0, W, H, 1.0)
    _scene_colored(ctx, vgt, **COLORS_B)
    s.update_paint_values(ctx)
    for name, old in zip(names, before):
        v = view_at(s, name)
        got = s.render(*v)
        equal(got, whole_scene_view(s, v), name)
        if name == "inside":
            assert float((got - old).abs().max()) > 0.05


@pytest.mark.parametrize("which", SCENES)
def test_rows_the_window_skips_are_never_read(scenes, which, monkeypatch):
    """Every coverage row K1's twin skips under the window (chunks of
    tiles outside it) is NaN before the fold and the composite: the image
    stays finite and equal to the whole-scene route."""
    s = scenes(which)
    views = [view_at(s, n) for n in ("inside", "off_left", "off_top", "fractional_x")]
    want = [whole_scene_view(s, v) for v in views]
    nan_rows = []

    def cov_all_nan(chunk_edges, tile_h, tile_w, window=None, chunk_tiles=None):
        cov = cov_all_torch(chunk_edges, tile_h, tile_w, window, chunk_tiles)
        assert window is not None
        skipped = torch.cat([~window.holds(t.long()) for t in chunk_tiles]
                            + [torch.zeros(1, dtype=torch.bool)])
        cov[skipped] = float("nan")
        nan_rows.append(int(skipped.sum()))
        return cov

    monkeypatch.setattr(coverage_ops, "cov_all_torch", cov_all_nan)
    for v, w in zip(views, want):
        got = s.render(*v, use_pallas=False)
        assert bool(torch.isfinite(got).all()), v
        equal(got, w, (which, v))
    assert min(nan_rows) > 0


def test_view_window_tiles_and_layout():
    """The window's scene tiles, clipped to the grid (empty off the
    scene), and K2's output addressing in both layouts."""
    w = ViewWindow(-2, 3, 4, 5, 6, 7, 8, 128, width=500, height=37)
    assert w.tiles == (0, 3, 2, 7)
    assert w.out_shape() == (37, 500, 4)
    assert w.layout() == (8 * 500, 128, 500, 500, 37)
    ids = torch.arange(6 * 7 + 1)
    assert w.holds(ids).nonzero().flatten().tolist() == [
        ty * 6 + tx for ty in range(3, 7) for tx in range(2)]
    assert ViewWindow(9, 0, 4, 5, 6, 7, 8, 128).tiles == (6, 0, 6, 5)
    assert ViewWindow(0, -9, 4, 5, 6, 7, 8, 128).tiles[1::2] == (0, 0)
    g = ViewWindow(1, 1, 4, 5, 6, 7, 8, 128)
    assert g.out_shape() == (20, 8, 128, 4)
    assert g.layout() == (4 * 8 * 128, 8 * 128, 128, 4 * 128, 5 * 8)
    # a tile placed into the image lands at its output pixels, clipped
    out = torch.zeros(w.out_shape())
    tile = torch.arange(8 * 128 * 4, dtype=torch.float32).view(1, 8, 128, 4)
    w.place(out, tile, torch.tensor([6 * 6 + 1]))     # scene (6, 1): output (3, 3)
    assert torch.equal(out[24:32, 384:500], tile[0, :, :116])
    assert float(out[:24].abs().sum()) == 0 and float(out[32:].abs().sum()) == 0


@pytest.mark.parametrize("form", ["init", "k_rep", "cov_final"])
def test_a_view_window_takes_forms_a_and_d_only(form):
    """frame_fb and K2's twin refuse a window with form (b), (c) or (e);
    K1's twin a window without the chunk tiles."""
    w = ViewWindow(0, 0, 1, 1, 1, 1, 8, 128, width=128, height=8)
    cov = torch.zeros((1, 8 * 128))
    kw = {"init": dict(init_tiles=torch.zeros((1, 8, 128, 4))),
          "k_rep": dict(k_rep=2),
          "cov_final": dict(cov_final_arr=cov)}[form]
    with pytest.raises(ValueError, match="forms \\(a\\) and \\(d\\)"):
        frame_fb(cov, [], [], [], [], None, BG, tile_h=8, tile_w=128,
                 num_tiles=1, bucket_flags=(), window=w, **kw)
    twin_kw = {"init": dict(init=True), "k_rep": dict(k_rep=2),
               "cov_final": dict(rbd=torch.zeros((1, 8, 1)))}[form]
    with pytest.raises(ValueError, match="forms \\(a\\) and \\(d\\)|coverage rows"):
        composite_bucket_into_torch(torch.zeros(w.out_shape()), cov,
                                    torch.zeros((1, 1), dtype=torch.int32),
                                    torch.zeros((1, 40, 1)), None, None,
                                    torch.zeros(1, dtype=torch.int32), BG,
                                    tile_w=128, flags=(False,) * 7, window=w,
                                    **twin_kw)
    with pytest.raises(ValueError, match="chunk-tile"):
        cov_all_torch([torch.zeros((1, 2, 4))], 8, 128, window=w)
