"""The port's retained-scene pan (vgtpu_torch/raster/retained.py) on the CPU at
ss=1: a baked scene rendered at a view offset against the port's own direct
end() of the translated scene and against vgtpu's RetainedScene.render on
the same recording — at vgtpu's tolerance (2e-4, tests/test_retained.py)
against its XLA pan (render(use_pallas=False)), and at 2e-6 against its
chunk-gather pan (render(use_pallas=True), Pallas in interpret mode), the
formulation the port runs.  The cases mirror tests/test_retained.py
(supersampled scenes and the fuzz cases: tests/test_torch_retained_ss.py),
except the A/B cases on vgtpu's two unported pan formulations and the
cached command-list replay (command lists are not ported)."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores
torch.set_num_threads(1)

import vgtpu as vgj  # noqa: E402
import vgtpu_torch as vgt  # noqa: E402
from tests.fontdata import FONT_DATA  # noqa: E402
from vgtpu.raster.retained import RetainedScene as RetainedSceneJ  # noqa: E402
from vgtpu_torch.raster.frame import image_to_u8  # noqa: E402
from vgtpu_torch.raster.retained import (  # noqa: E402
    RetainedScene,
    _blend_over_tiles,
    _pan_frame_fused,
    measure_pan_ms_per_frame,
)

W, H = 384, 160
BG = (0.1, 0.1, 0.12, 1.0)
ATOL = 2e-4           # pan against a direct render (vgtpu's tolerance)
ATOL_CG = 2e-6        # against vgtpu's chunk-gather pan
ATOL_TEX = 3e-3       # textured pan against a direct render (vgtpu's)
VIEWS = [(0, 0), (37, 5), (128, 8), (129, 9), (-45, -13), (300, 100),
         (-127, -7), (5, -3)]
needs_font = pytest.mark.skipif(FONT_DATA is None, reason="no test font")


def scene(ctx, vg):
    """tests/test_retained.py's _scene: both fill rules, a gradient, a
    stroke, a clip group under a scissor and a tri batch."""
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 8, 8, 200, 120, 12)
    vg.fillPath(ctx, vg.color4ub(40, 90, 160, 255), vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    star = [(60 + 50 * np.cos(-np.pi / 2 + k * 4 * np.pi / 5),
             70 + 50 * np.sin(-np.pi / 2 + k * 4 * np.pi / 5)) for k in range(5)]
    vg.moveTo(ctx, *star[0])
    for p in star[1:]:
        vg.lineTo(ctx, *p)
    vg.closePath(ctx)
    vg.fillPath(ctx, vg.color4ub(250, 200, 40, 200), vg.FillFlags.ConcaveEvenOddAA)
    g = vg.createLinearGradient(ctx, 220, 20, 360, 20, vg.color4ub(255, 0, 80, 255),
                                vg.color4ub(0, 220, 255, 255))
    vg.beginPath(ctx)
    vg.rect(ctx, 220, 20, 140, 40)
    vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.moveTo(ctx, 230, 90)
    vg.cubicTo(ctx, 260, 60, 320, 140, 360, 100)
    vg.strokePath(ctx, vg.color4ub(240, 240, 240, 255), 3.0, vg.StrokeFlags.RoundRoundAA)
    vg.pushState(ctx)
    vg.setScissor(ctx, 20, 96, 160, 40)
    vg.beginClip(ctx, vg.ClipRule.In)
    vg.beginPath(ctx)
    vg.circle(ctx, 80, 116, 30)
    vg.fillPath(ctx, vg.Colors.Black, vg.FillFlags.ConvexAA)
    vg.endClip(ctx)
    for i in range(4):
        vg.beginPath(ctx)
        vg.rect(ctx, 30 + i * 30, 100, 20, 32)
        vg.fillPath(ctx, vg.color4ub(30 + 60 * i, 200, 90, 255), vg.FillFlags.ConvexAA)
    vg.resetClip(ctx)
    vg.popState(ctx)
    pos = np.array([[300, 120], [340, 120], [320, 150]], np.float32)
    col = np.array([vg.color4ub(255, 0, 0, 255), vg.color4ub(0, 255, 0, 255),
                    vg.color4ub(0, 0, 255, 255)], np.uint32)
    vg.indexedTriList(ctx, pos, None, 3, col, 3, np.array([0, 1, 2], np.uint16), 3, None)


def context(vg, **cfg):
    """A context of `vg` (the port's on the CPU)."""
    c = vg.ContextConfig(**cfg)
    return vg.createContext(c, device="cpu") if vg is vgt else vg.createContext(c)


def bake(vg, draw, bg=BG, w=W, h=H, dpr=1.0, **cfg):
    """Record draw(ctx, vg) through `vg` and bake it with that package's
    RetainedScene."""
    ctx = context(vg, **cfg)
    vg.begin(ctx, 0, w, h, dpr)
    draw(ctx, vg)
    cls = RetainedScene if vg is vgt else RetainedSceneJ
    return cls.bake(ctx, background=bg)


def direct(draw, view, bg=BG, w=W, h=H, dpr=1.0, **cfg):
    """The port's end() of the scene translated by -view (in framebuffer
    pixels, so a logical translate of view/dpr)."""
    ctx = context(vgt, **cfg)
    vgt.begin(ctx, 0, w, h, dpr)
    vgt.pushState(ctx)
    vgt.transformTranslate(ctx, -view[0] / dpr, -view[1] / dpr)
    draw(ctx, vgt)
    vgt.popState(ctx)
    return vgt.end(ctx, background=bg).numpy()


def u8_levels(a, b) -> int:
    return int(np.abs(image_to_u8(arr(a)).astype(np.int16)
                      - image_to_u8(arr(b)).astype(np.int16)).max())


def arr(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, atol, what=""):
    got, want = arr(got), arr(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=str(what))


@pytest.fixture(scope="module")
def pair():
    """The main scene baked by the port and by vgtpu."""
    return bake(vgt, scene), bake(vgj, scene)


@pytest.mark.parametrize("view", VIEWS)
def test_pan_matches_direct(pair, view):
    st, sj = pair
    got = st.render(*view)
    assert got.shape == (H, W, 4) and got.dtype == torch.float32
    close(got, direct(scene, view), ATOL, view)
    close(got, sj.render(*view), ATOL, view)


def test_pan_matches_vgtpu_chunk_gather_pan(pair):
    """vgtpu's chunk-gather pan (frame_fb_pallas, interpret mode) is the
    formulation the port runs: per-offset P_BD rows, the OX/OY residual,
    integer and fractional x."""
    st, sj = pair
    for view in [(37, 5), (-45, -13), (128.5, 8)]:
        close(st.render(*view), sj.render(*view, use_pallas=True), ATOL_CG, view)


def test_plain_route_equals_dispatch_on_cpu(pair):
    """render(plain=True) forces the plain twins; on the CPU the dispatchers
    take them too, so the two are one computation."""
    st, _sj = pair
    assert torch.equal(st.render(37, 5), st.render(37, 5, plain=True))


def _scene_colored(ctx, vg, card, star, g0, g1, stroke):
    """scene's first four draws with parameterized solid/gradient VALUES."""
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 8, 8, 200, 120, 12)
    vg.fillPath(ctx, vg.color4ub(*card), vg.FillFlags.ConvexAA)
    pts = [(60 + 50 * np.cos(-np.pi / 2 + k * 4 * np.pi / 5),
            70 + 50 * np.sin(-np.pi / 2 + k * 4 * np.pi / 5)) for k in range(5)]
    vg.beginPath(ctx)
    vg.moveTo(ctx, *pts[0])
    for p in pts[1:]:
        vg.lineTo(ctx, *p)
    vg.closePath(ctx)
    vg.fillPath(ctx, vg.color4ub(*star), vg.FillFlags.ConcaveEvenOddAA)
    g = vg.createLinearGradient(ctx, 220, 20, 360, 20, vg.color4ub(*g0), vg.color4ub(*g1))
    vg.beginPath(ctx)
    vg.rect(ctx, 220, 20, 140, 40)
    vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.moveTo(ctx, 230, 90)
    vg.cubicTo(ctx, 260, 60, 320, 140, 360, 100)
    vg.strokePath(ctx, vg.color4ub(*stroke), 3.0, vg.StrokeFlags.RoundRoundAA)


COLORS_A = dict(card=(40, 90, 160, 255), star=(250, 200, 40, 200),
                g0=(255, 0, 80, 255), g1=(0, 220, 255, 255), stroke=(240, 240, 240, 255))
COLORS_B = dict(card=(160, 40, 90, 255), star=(40, 250, 160, 140),
                g0=(80, 255, 0, 255), g1=(255, 0, 220, 255), stroke=(20, 20, 220, 255))


def _colored(colors):
    return lambda c, vg: _scene_colored(c, vg, **colors)


def test_update_paint_values_matches_fresh_bake():
    """Pan + colour animation: patching new solid/gradient values into a
    retained scene renders exactly like a fresh bake of those values."""
    ctx = context(vgt)
    vgt.begin(ctx, 0, W, H, 1.0)
    _scene_colored(ctx, vgt, **COLORS_A)
    s = RetainedScene.bake(ctx, background=BG)
    before = s.render(37, 5).clone()
    vgt.begin(ctx, 0, W, H, 1.0)
    _scene_colored(ctx, vgt, **COLORS_B)
    s.update_paint_values(ctx)
    want = bake(vgt, _colored(COLORS_B))
    for view in [(0, 0), (37, 5), (-45, -13)]:
        close(s.render(*view), want.render(*view), 2e-6, view)
    assert float((s.render(37, 5) - before).abs().max()) > 0.05
    close(s.render(37, 5), bake(vgj, _colored(COLORS_B)).render(37, 5), ATOL)


def test_update_paint_values_rejects_structure_and_opacity_flip():
    ctx = context(vgt)
    vgt.begin(ctx, 0, W, H, 1.0)
    _scene_colored(ctx, vgt, **COLORS_A)
    s = RetainedScene.bake(ctx, background=BG)
    vgt.begin(ctx, 0, W, H, 1.0)
    _scene_colored(ctx, vgt, **COLORS_A)
    vgt.beginPath(ctx)
    vgt.circle(ctx, 300, 30, 9)
    vgt.fillPath(ctx, vgt.Colors.Red, vgt.FillFlags.ConvexAA)
    with pytest.raises(ValueError, match="structure"):
        s.update_paint_values(ctx)
    vgt.begin(ctx, 0, W, H, 1.0)
    _scene_colored(ctx, vgt, **dict(COLORS_A, card=(40, 90, 160, 120)))
    with pytest.raises(ValueError, match="opacity"):
        s.update_paint_values(ctx)


def test_update_paint_values_evenodd_alpha_flip_allowed():
    """Only NonZero solids can be occlusion covers, so an even-odd fill may
    cross the alpha>=1 boundary freely."""
    ctx = context(vgt)
    vgt.begin(ctx, 0, W, H, 1.0)
    _scene_colored(ctx, vgt, **COLORS_A)
    s = RetainedScene.bake(ctx, background=BG)
    new = dict(COLORS_A, star=(250, 200, 40, 255))
    vgt.begin(ctx, 0, W, H, 1.0)
    _scene_colored(ctx, vgt, **new)
    s.update_paint_values(ctx)
    close(s.render(11, 3), bake(vgt, _colored(new)).render(11, 3), 2e-6)


def _img16(seed=11):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (16, 16, 4), np.uint8)
    img[..., 3] = 255
    return img


def _pattern_scene(h, rect_col=(200, 60, 40, 255)):
    def draw(ctx, vg):
        p = vg.createImagePattern(ctx, 40, 20, 64, 64, 0.0, h(ctx, vg))
        vg.beginPath(ctx)
        vg.roundedRect(ctx, 30, 15, 200, 90, 10)
        vg.fillPath(ctx, p, vg.Colors.White, vg.FillFlags.ConvexAA)
        vg.beginPath(ctx)
        vg.rect(ctx, 250, 30, 80, 60)
        vg.fillPath(ctx, vg.color4ub(*rect_col), vg.FillFlags.ConvexAA)
    return draw


def _new_image(img):
    return lambda ctx, vg: vg.createImage(ctx, 16, 16, 0, img)


def test_textured_scene_views_and_paint_update():
    """render_views and update_paint_values on a scene WITH sampling groups:
    each view resamples, and solid patches coexist with byte-identical
    texture draws; against vgtpu's pan of the same recording."""
    img = _img16()
    ctx = context(vgt)
    himg = vgt.createImage(ctx, 16, 16, 0, img)
    vgt.begin(ctx, 0, W, H, 1.0)
    _pattern_scene(lambda c, vg: himg)(ctx, vgt)
    s = RetainedScene.bake(ctx, background=(0.08, 0.08, 0.1, 1.0))
    assert s.samp_meta is not None
    views = [(0, 0), (41, 6), (-23, -11)]
    stack = s.render_views(views)
    sj = bake(vgj, _pattern_scene(_new_image(img)), bg=(0.08, 0.08, 0.1, 1.0))
    for k, view in enumerate(views):
        close(stack[k], s.render(*view), 2e-6, view)
        close(stack[k], sj.render(*view), ATOL, view)
    vgt.begin(ctx, 0, W, H, 1.0)
    _pattern_scene(lambda c, vg: himg, (40, 200, 160, 255))(ctx, vgt)
    s.update_paint_values(ctx)
    want = bake(vgt, _pattern_scene(_new_image(img), (40, 200, 160, 255)),
                bg=(0.08, 0.08, 0.1, 1.0))
    for view in views:
        close(s.render(*view), want.render(*view), 2e-6, view)


def test_fractional_x_pan_matches_direct(pair):
    """FRACTIONAL view_x renders exactly (the residual rides the float
    _P_OX row and the edge shift, neither rounded); fractional view_y is
    rejected."""
    st, sj = pair
    for view in [(37.5, 5), (12.25, 0), (-3.75, -13)]:
        got = st.render(*view)
        close(got, direct(scene, view), ATOL, view)
        close(got, sj.render(*view), ATOL, view)
    stack = st.render_views([(37.5, 5), (12.25, 0)])
    close(stack[0], direct(scene, (37.5, 5)), ATOL)
    close(stack[1], direct(scene, (12.25, 0)), ATOL)
    with pytest.raises(ValueError, match="view_y"):
        st.render(0, 2.5)
    with pytest.raises(ValueError, match="view_y"):
        st.render_views([(0, 2.5)])
    with pytest.raises(ValueError, match="pairs"):
        st.render_views([])


def test_fractional_x_pan_textured_matches_direct():
    """Fractional x through the texture resample: sample positions differ
    from the direct render's by exactly the translation."""
    draw = _pattern_scene(_new_image(_img16()))
    bg = (0.08, 0.08, 0.1, 1.0)
    s = bake(vgt, draw, bg=bg)
    for view in [(41.5, 6), (-22.75, -11)]:
        close(s.render(*view), direct(draw, view, bg=bg), ATOL_TEX, view)


def test_render_views_matches_per_view(pair):
    st, _sj = pair
    stack = st.render_views(VIEWS)
    assert stack.shape == (len(VIEWS), H, W, 4)
    for k, view in enumerate(VIEWS):
        close(stack[k], st.render(*view), 2e-6, view)


def test_render_tiles_is_the_output_tile_grid(pair):
    """render_tiles is render's image as its (nty*ntx, th, tw, 4) tile grid;
    off-scene tiles take the given background."""
    st, _sj = pair
    tiles = st.render_tiles(37, 5)
    ntx, nty = -(-W // 128), -(-H // 8)
    assert tiles.shape == (nty * ntx, 8, 128, 4)
    img = tiles.reshape(nty, ntx, 8, 128, 4).permute(0, 2, 1, 3, 4).reshape(
        nty * 8, ntx * 128, 4)[:H, :W]
    assert torch.equal(img, st.render(37, 5))
    far = st.render_tiles(5000, 5000, background=(0.0, 0.5, 0.0, 1.0))
    assert torch.equal(far, torch.tensor([0.0, 0.5, 0.0, 1.0]).expand_as(far))


def test_pan_off_scene_is_background(pair):
    st, _sj = pair
    img = st.render(5000, 5000)
    close(img, np.broadcast_to(np.asarray(BG, np.float32), img.shape), 1e-6)


def test_empty_scene_renders_background():
    ctx = context(vgt)
    vgt.begin(ctx, 0, 256, 64, 1.0)
    s = RetainedScene.bake(ctx, background=(0.2, 0.3, 0.4, 1.0))
    img = s.render(10, -5)
    assert img.shape == (64, 256, 4)
    close(img, np.broadcast_to(np.array([0.2, 0.3, 0.4, 1.0], np.float32),
                               img.shape), 1e-6)


def test_pan_image_pattern_matches_direct():
    """Image-pattern fills resample at the shifted view: integer shifts of
    bilinear sampling are exact, so pan == direct (and vgtpu's pan)."""
    draw = _pattern_scene(_new_image(_img16()))
    bg = (0.08, 0.08, 0.1, 1.0)
    s, sj = bake(vgt, draw, bg=bg), bake(vgj, draw, bg=bg)
    for view in [(0, 0), (41, 6), (-23, -11), (130, 9)]:
        got = s.render(*view)
        close(got, direct(draw, view, bg=bg), ATOL_TEX, view)
        close(got, sj.render(*view), ATOL, view)


def test_textured_bucket_with_an_untextured_slot():
    """A bucket whose texture lane is on holds slots of untextured draws
    (solid fills over and under the pattern, and pad slots): those read
    the colour-tile scratch row, the zeros row flat_color_tiles appends at
    NCT (vgtpu points them at NCT+1, which its gather clamps to the same
    row)."""
    img = _img16(5)

    def draw(ctx, vg):
        vg.beginPath(ctx)
        vg.rect(ctx, 20, 10, 220, 70)
        vg.fillPath(ctx, vg.color4ub(30, 60, 200, 255), vg.FillFlags.ConvexAA)
        p = vg.createImagePattern(ctx, 10, 5, 48, 48, 0.0, vg.createImage(ctx, 16, 16, 0, img))
        vg.beginPath(ctx)
        vg.rect(ctx, 40, 20, 150, 60)
        vg.fillPath(ctx, p, vg.color4ub(255, 255, 255, 200), vg.FillFlags.ConvexAA)
        vg.beginPath(ctx)
        vg.circle(ctx, 110, 50, 25)
        vg.fillPath(ctx, vg.color4ub(250, 120, 30, 160), vg.FillFlags.ConvexAA)

    bg = (0.05, 0.05, 0.05, 1.0)
    s = bake(vgt, draw, bg=bg)
    nct = s.samp_nct
    mixed = [ct for ct, fl in zip(s.d["bucket_ctile"], s.d["bucket_flags"])
             if fl[2] and bool((ct == nct).any()) and bool((ct < nct).any())]
    assert mixed, "no texture bucket holds an untextured slot"
    sj = bake(vgj, draw, bg=bg)
    for view in [(0, 0), (37, 5), (-19, -6)]:
        got = s.render(*view)
        close(got, direct(draw, view, bg=bg), ATOL_TEX, view)
        close(got, sj.render(*view), ATOL, view)


@needs_font
def test_pan_text_matches_direct():
    """Text pans exactly: atlas quads resampled at the shifted origins."""
    def draw(c, vg):
        f = vg.createFont(c, "sans", FONT_DATA, len(FONT_DATA), 0)
        cfg = vg.makeTextConfig(c, f, 20.0, vg.TextAlign.TopLeft,
                                vg.color4ub(240, 240, 200, 255))
        vg.text(c, cfg, 24, 40, "Pan me exactly!")
        vg.beginPath(c)
        vg.rect(c, 20, 70, 160, 30)
        vg.fillPath(c, vg.color4ub(40, 80, 160, 255), vg.FillFlags.ConvexAA)

    s = bake(vgt, draw)
    assert s.samp_meta is not None
    for view in [(0, 0), (37, 5), (-19, -6)]:
        close(s.render(*view), direct(draw, view), ATOL_TEX, view)


def test_explicit_viewport_scissor_rides_scene():
    """An EXPLICIT setScissor equal to the viewport is a scene-space clip;
    only the implicit default is screen-space."""
    bg = (0.05, 0.05, 0.05, 1.0)

    def draw(ctx, vg):
        vg.setScissor(ctx, 0, 0, W, H)
        vg.beginPath(ctx)
        vg.rect(ctx, -60, -40, W + 120, H + 80)
        vg.fillPath(ctx, vg.color4ub(200, 120, 40, 255), vg.FillFlags.ConvexAA)

    s = bake(vgt, draw, bg=bg)
    for view in [(-30, -20), (25, 7)]:
        close(s.render(*view), direct(draw, view, bg=bg), ATOL, view)


def test_pan_dpr2_matches_direct():
    """Under devicePixelRatio=2 view offsets are framebuffer pixels; the
    direct equivalent is a logical translate of view/dpr."""
    bg = (0.1, 0.1, 0.1, 1.0)

    def draw(ctx, vg):
        vg.beginPath(ctx)
        vg.circle(ctx, 60, 40, 25)
        vg.fillPath(ctx, vg.color4ub(200, 80, 40, 255), vg.FillFlags.ConvexAA)
        vg.beginPath(ctx)
        vg.moveTo(ctx, 20, 70)
        vg.lineTo(ctx, 180, 30)
        vg.strokePath(ctx, vg.Colors.White, 3.0, vg.StrokeFlags.RoundRoundAA)

    s = bake(vgt, draw, bg=bg, w=200, h=100, dpr=2.0)
    for view in [(17, 9), (-40, 12)]:
        close(s.render(*view), direct(draw, view, bg=bg, w=200, h=100, dpr=2.0),
              3e-4, view)


@pytest.mark.parametrize("pools", [(2, 8, 48), (2, 8, 2048)])
def test_pan_with_deep_chunk_pools(pools):
    """The bake's ladder comes from ContextConfig.chunk_pools: chunks of 48
    and of up to 2,048 edges (kernel K1's deep form on CUDA) pan too, the
    dead row and the gather map built on the repacked plan."""
    def draw(ctx, vg):
        vg.beginPath(ctx)
        t = np.linspace(0, 2 * np.pi, 400, endpoint=False)
        r = 60 + 25 * np.sin(9 * t)
        vg.polyline(ctx, np.stack([190 + r * np.cos(t), 80 + 0.9 * r * np.sin(t)], 1))
        vg.closePath(ctx)
        vg.fillPath(ctx, vg.color4ub(220, 90, 40, 230), vg.FillFlags.ConcaveNonZeroAA)
        scene(ctx, vg)

    s = bake(vgt, draw, chunk_pools=pools)
    assert max(ce.shape[1] for ce, _ in s.plan.chunk_pools) == pools[-1]
    sj = bake(vgj, draw, chunk_pools=pools)
    for view in [(37, 5), (-45.5, -13)]:
        got = s.render(*view)
        close(got, sj.render(*view), ATOL, view)
        # the star's 400 near-vertical edges sit where the bake's host
        # translate and the pan's device shift round apart: 2.1e-4 from the
        # direct render, as far for vgtpu's pan; hold the image to 1 u8 level
        want = direct(draw, view, chunk_pools=pools)
        assert u8_levels(got, want) <= 1, view


def test_measure_pan_ms_per_frame_on_the_cpu(pair):
    st, _sj = pair
    ms = measure_pan_ms_per_frame(st, reps_hi=3, reps_lo=1)
    assert np.isfinite(ms)
    with pytest.raises(ValueError, match="reps_hi"):
        measure_pan_ms_per_frame(st, reps_hi=1, reps_lo=1)


@pytest.mark.parametrize("call", [_pan_frame_fused, _blend_over_tiles],
                         ids=["_pan_frame_fused", "_blend_over_tiles"])
def test_cached_list_pan_layer_is_not_ported(call):
    with pytest.raises(NotImplementedError, match="command lists"):
        call()


def test_nearest_texel_ties_pan_as_vgtpu_does():
    """A nearest-filter pattern whose origin sits on a pixel centre puts
    samples exactly on texel ties (round(-0.5)): the bake's translated
    paint matrix and a direct render's round apart there, so the pan can
    take the other texel than the direct render — as vgtpu's pan does.
    The port's pan follows vgtpu's on the same recording."""
    img = np.random.default_rng(3).integers(0, 256, (64, 64, 4), np.uint8)

    def draw(ctx, vg):
        h = vg.createImage(ctx, 64, 64, vg.ImageFlags.Filter_Nearest, img)
        p = vg.createImagePattern(ctx, 50.5, 40.25, 128, 80, 0.0, h)
        vg.beginPath(ctx)
        vg.rect(ctx, 20, 20, 220, 130)
        vg.fillPath(ctx, p, vg.Colors.White, vg.FillFlags.ConvexAA)

    bg = (0.05, 0.05, 0.05, 1.0)
    s, sj = bake(vgt, draw, bg=bg), bake(vgj, draw, bg=bg)
    flips = 0
    for view in [(0, 0), (37, 5), (-45, -13)]:
        got = s.render(*view)
        close(got, sj.render(*view), ATOL, view)
        flips += int((np.abs(arr(got) - direct(draw, view, bg=bg)).max(-1) > 0.01).sum())
    assert flips > 0, "no texel tie flipped: the case no longer shows the property"
