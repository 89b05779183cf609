"""The port's frame, paint and layer memos on the CPU.

Every frame of a sequence goes through three contexts: the port with its
memos on, the port with frame_memo=False (every end() takes the full path:
bin, sample, upload, render), and vgtpu's end() on the same sequence, all
three sampling textures on the device (device_sampling, both packages'
default).  The
memo frame is held to both at atol=1e-5 and 1 u8 level after image_to_u8
(vgtpu renders its XLA scan on the CPU, the port its fused twins; the fold's
index_add_ can reorder against the full path), and the profiler counters
must show that the short path was taken.  The cases mirror
tests/test_paint_memo.py and tests/test_layer_memo.py."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores
torch.set_num_threads(1)

import vgtpu as vgj  # noqa: E402
import vgtpu_torch as vgt  # noqa: E402
from tests.fontdata import FONT_DATA  # noqa: E402
from vgtpu.raster.frame import image_to_u8 as image_to_u8_j  # noqa: E402
from vgtpu_torch.raster.frame import image_to_u8  # noqa: E402

W, H = 320, 160
BG = (0.1, 0.1, 0.12, 1.0)
ATOL = 1e-5

needs_font = pytest.mark.skipif(FONT_DATA is None, reason="no test font")


def _close(got, ref, what):
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0, err_msg=what)
    u8 = np.abs(image_to_u8(got).astype(np.int16)
                - image_to_u8_j(ref).astype(np.int16)).max()
    assert u8 <= 1, f"{what}: {u8} u8 levels"


class Trio:
    """The port (memos on), the port's full path and vgtpu, fed the same
    frames.  setup(ctx, vg) runs once per context and returns the state its
    draw functions take (fonts, image handles)."""

    def __init__(self, setup=None, **cfg):
        full = dict(cfg, frame_memo=False)
        self.ctxs = [
            (vgt.createContext(vgt.ContextConfig(**cfg), device="cpu"), vgt),
            (vgt.createContext(vgt.ContextConfig(**full), device="cpu"), vgt),
            (vgj.createContext(vgj.ContextConfig(**cfg)), vgj),
        ]
        self.state = [setup(c, vg) if setup else None for c, vg in self.ctxs]
        self.port = self.ctxs[0][0]
        self.n = 0

    def frame(self, draw, bg=BG, w=W, h=H):
        imgs = []
        for (c, vg), st in zip(self.ctxs, self.state):
            vg.begin(c, 0, w, h, 1.0)
            draw(c, vg, st)
            out = vg.end(c, background=bg)
            imgs.append(out.numpy() if isinstance(out, torch.Tensor)
                        else np.asarray(out))
        _close(imgs[0], imgs[1], f"frame {self.n}: memo vs the port's full path")
        _close(imgs[0], imgs[2], f"frame {self.n}: memo vs vgtpu")
        self.n += 1
        return imgs[0]

    def count(self, name):
        return self.port.profiler.counters.get(name, 0)


# ---- paint memo (tests/test_paint_memo.py) ----------------------------------

def _font(ctx, vg):
    return (vg.createFont(ctx, "sans", FONT_DATA, len(FONT_DATA), 0)
            if FONT_DATA is not None else None)


def draw_scene(ctx, vg, font, *, rect_col, circ_col,
               grad=((250, 60, 40, 255), (40, 60, 250, 255)),
               grad_geo=(20.0, 20.0, 200.0, 90.0), alpha=1.0,
               text_col=(255, 255, 255, 255), stroke_col=(20, 220, 120, 255)):
    vg.setGlobalAlpha(ctx, alpha)
    g = vg.createLinearGradient(ctx, *grad_geo,
                                vg.color4ub(*grad[0]), vg.color4ub(*grad[1]))
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 15, 15, 120, 80, 12)
    vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.circle(ctx, 200, 60, 38)
    vg.fillPath(ctx, vg.color4ub(*circ_col), vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.rect(ctx, 170, 30, 110, 70)
    vg.fillPath(ctx, vg.color4ub(*rect_col), vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.moveTo(ctx, 20, 140)
    vg.cubicTo(ctx, 90, 100, 180, 150, 300, 115)
    vg.strokePath(ctx, vg.color4ub(*stroke_col), 4.0, vg.StrokeFlags.RoundRoundAA)
    if font is not None and text_col is not None:
        cfg = vg.makeTextConfig(ctx, "sans", 20.0,
                                vg.TextAlign.Left | vg.TextAlign.Top,
                                vg.color4ub(*text_col))
        vg.text(ctx, cfg, 30, 110, "paint memo")


BASE = dict(rect_col=(90, 140, 220, 160), circ_col=(250, 210, 60, 255))


def _scene(**kw):
    return lambda c, vg, font: draw_scene(c, vg, font, **kw)


def _anim(frames, **cfg):
    """Run draw_scene over a list of kwargs; returns the Trio."""
    t = Trio(_font, **cfg)
    for kw in frames:
        t.frame(_scene(**kw))
    return t


def test_redraw_is_a_memo_hit():
    """An identical re-record re-renders the resident plan: no finalize,
    bin or upload."""
    t = _anim([BASE] * 3)
    assert t.count("memo_hits") == 2 and t.count("memo_paint_hits") == 0
    assert t.port.profiler.times_ms.get("bin", 0) > 0
    assert t.port.profiler._frames == 3


def test_solid_recolor_takes_fast_path():
    t = _anim([BASE, dict(BASE, rect_col=(220, 70, 50, 160))])
    assert t.count("memo_paint_hits") == 1


def test_gradient_value_and_geometry_change_take_fast_path():
    t = _anim([BASE, dict(BASE, grad=((30, 230, 90, 255), (240, 240, 40, 200)),
                          grad_geo=(40.0, 10.0, 120.0, 140.0))])
    assert t.count("memo_paint_hits") == 1


def test_global_alpha_fade_takes_fast_path():
    """The fade resolves into every solid/gradient row; with text the
    modulated text colour is a texture value and patches by resampling."""
    base = dict(BASE, alpha=0.9, circ_col=(250, 210, 60, 230))
    t = Trio(_font)
    t.frame(_scene(**base))
    for hits, a in enumerate((0.75, 0.6, 0.45), start=1):
        t.frame(_scene(**dict(base, alpha=a)))
        assert t.count("memo_paint_hits") == hits


def test_opacity_class_flip_falls_back():
    """The opaque rect occludes part of the circle; making it translucent
    must take the full path so the circle shows through again."""
    t = _anim([dict(rect_col=(90, 140, 220, 255), circ_col=(250, 210, 60, 255)),
               dict(rect_col=(90, 140, 220, 120), circ_col=(250, 210, 60, 255))])
    assert t.count("memo_paint_hits") == 0 and t.count("memo_hits") == 0


def test_opaque_to_opaque_recolor_of_cover_is_fast():
    t = _anim([dict(rect_col=(90, 140, 220, 255), circ_col=(250, 210, 60, 255)),
               dict(rect_col=(20, 200, 180, 255), circ_col=(250, 210, 60, 255))])
    assert t.count("memo_paint_hits") == 1


@needs_font
def test_text_recolor_takes_fast_path():
    t = _anim([BASE, dict(BASE, text_col=(255, 120, 40, 255))])
    assert t.count("memo_paint_hits") == 1


def _checker():
    img = np.zeros((64, 64, 4), np.uint8)
    yy, xx = np.mgrid[0:64, 0:64]
    c = ((yy // 8 + xx // 8) % 2).astype(np.uint8)
    img[..., 0] = 40 + 180 * c
    img[..., 1] = 200 - 120 * c
    img[..., 2] = 90 + 60 * c
    img[..., 3] = 255
    return img


def _pattern_setup(ctx, vg):
    return vg.createImage(ctx, 64, 64, 0, _checker())


def _pattern_scene(cx, cy, angle=0.0, rect_col=(90, 140, 220, 160)):
    def draw(ctx, vg, h):
        p = vg.createImagePattern(ctx, cx, cy, 96.0, 96.0, angle, h)
        vg.beginPath(ctx)
        vg.rect(ctx, 10, 10, 220, 120)
        vg.fillPath(ctx, p, vg.Colors.White, vg.FillFlags.ConvexAA)
        vg.beginPath(ctx)
        vg.rect(ctx, 200, 30, 100, 100)
        vg.fillPath(ctx, vg.color4ub(*rect_col), vg.FillFlags.ConvexAA)
    return draw


def test_pattern_pan_takes_fast_path():
    """Animating the pattern's paint matrix changes only the P_IMAGE row:
    the patch resamples the colour tiles and swaps ct_flat; a rotation
    (the sampler's other path) and a solid recolour in the same delta
    patch too."""
    t = Trio(_pattern_setup)
    t.frame(_pattern_scene(40.0, 20.0))
    ct0 = t.port.last_device_arrays["ct_flat"]
    steps = [(52.0, 26.0, 0.0, (90, 140, 220, 160)),
             (17.0, 5.0, 0.0, (90, 140, 220, 160)),
             (40.0, 20.0, 0.4, (90, 140, 220, 160)),
             (55.0, 31.0, 0.0, (250, 60, 60, 200))]
    for hits, (cx, cy, ang, col) in enumerate(steps, start=1):
        t.frame(_pattern_scene(cx, cy, ang, col))
        assert t.count("memo_paint_hits") == hits
    assert t.port.last_device_arrays["ct_flat"] is not ct0


def test_updateImage_takes_fast_path():
    """updateImage + a geometry-identical re-record: the image generation
    rides the texture signature, the patch resamples."""
    img = _checker()

    def content(step):
        out = img.copy()
        out[:, :, 0] = (out[:, :, 0].astype(int) + 40 * step) % 256
        return out

    def frame(step):
        def draw(ctx, vg, h):
            if step:
                vg.updateImage(ctx, h, 0, 0, 64, 64, content(step))
            _pattern_scene(40.0, 20.0)(ctx, vg, h)
        return draw

    t = Trio(_pattern_setup)
    for step in (0, 1, 2):
        t.frame(frame(step))
        assert t.count("memo_paint_hits") == step


def test_textured_trilist_takes_full_path():
    """A textured indexedTriList has paint=None (its values live in
    tri_paints), so updateImage on its image must take the full path."""
    img2 = _checker()
    img2[..., 0] = 255

    def frame(update):
        def draw(ctx, vg, h):
            if update:
                vg.updateImage(ctx, h, 0, 0, 64, 64, img2)
            pos = [(20, 20), (120, 20), (120, 100), (20, 100)]
            uv = [(0, 0), (1, 0), (1, 1), (0, 1)]
            vg.indexedTriList(ctx, pos, uv, 4, [vg.Colors.White], 1,
                              [0, 1, 2, 0, 2, 3], 6, h)
        return draw

    t = Trio(_pattern_setup)
    first = t.frame(frame(False))
    got = t.frame(frame(True))
    assert t.count("memo_paint_hits") == 0 and t.count("memo_hits") == 0
    assert not np.allclose(got, first)


def test_supersample_recolor_fast_path():
    """ss=2: the resident split plan (forms (d)/(e)) takes the patch; its
    resolve params do not depend on paint values."""
    t = Trio(None, coverage_supersample=2)
    t.frame(_scene(**BASE))
    assert t.port.last_device_arrays["res"] is not None
    t.frame(_scene(**dict(BASE, rect_col=(250, 40, 160, 200),
                          stroke_col=(240, 240, 40, 255))))
    assert t.count("memo_paint_hits") == 1


def test_paint_memo_disabled_takes_full_path():
    t = _anim([BASE, dict(BASE, rect_col=(220, 70, 50, 160))], paint_memo=False)
    assert t.count("memo_paint_hits") == 0


def test_fuzz_random_recolors():
    """Random solid + gradient + text value mutations (opacity classes kept):
    every frame patches and matches."""
    rng = np.random.default_rng(5)

    def kwargs():
        return dict(
            rect_col=tuple(int(v) for v in rng.integers(0, 256, 3)) + (160,),
            circ_col=tuple(int(v) for v in rng.integers(0, 255, 3)) + (200,),
            grad=(tuple(int(v) for v in rng.integers(0, 256, 4)),
                  tuple(int(v) for v in rng.integers(0, 256, 4))),
            grad_geo=(float(rng.uniform(0, 60)), float(rng.uniform(0, 40)),
                      float(rng.uniform(100, 250)), float(rng.uniform(60, 150))),
            text_col=tuple(int(v) for v in rng.integers(0, 256, 3)) + (255,),
            stroke_col=tuple(int(v) for v in rng.integers(0, 256, 3)) + (180,),
        )

    t = _anim([kwargs() for _ in range(5)])
    assert t.count("memo_paint_hits") == 4


def test_patched_params_equal_a_fresh_upload():
    """The device patch rewrites the 18 paint rows of every resident
    bucket: bit-equal to a fresh upload of the same frame, pad and invalid
    slots included (build_bucket_aux gives them entry 0's paint)."""
    kw = dict(BASE, rect_col=(220, 70, 50, 160), circ_col=(20, 40, 60, 255))
    t = _anim([BASE, kw])
    assert t.count("memo_paint_hits") == 1
    fresh = vgt.createContext(device="cpu")
    vgt.begin(fresh, 0, W, H, 1.0)
    draw_scene(fresh, vgt, _font(fresh, vgt), **kw)
    vgt.end(fresh, background=BG)
    a, b = t.port.last_device_arrays, fresh.last_device_arrays
    assert len(a["bucket_params"]) == len(b["bucket_params"])
    for pa, pb in zip(a["bucket_params"], b["bucket_params"]):
        assert torch.equal(pa, pb)
    assert torch.equal(a["ct_flat"], b["ct_flat"])


# ---- layer memo (tests/test_layer_memo.py) ----------------------------------

LBG = (0.10, 0.12, 0.14, 1.0)


def _static_prefix(ctx, vg, n=20):
    for i in range(n):
        vg.beginPath(ctx)
        vg.circle(ctx, 20 + 14 * (i % 10), 30 + 40 * (i // 10), 9 + (i % 3))
        vg.fillPath(ctx, vg.color4ub(40 + 10 * i, 200 - 7 * i, 90, 200),
                    vg.FillFlags.ConvexAA)


def _ui(ctx, vg, t: float):
    vg.beginPath(ctx)
    vg.rect(ctx, 30 + 50 * t, 100, 60, 30)
    vg.fillPath(ctx, vg.color4ub(250, 210, 60, 220), vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.moveTo(ctx, 200, 20 + 30 * t)
    vg.lineTo(ctx, 280, 60)
    vg.strokePath(ctx, vg.color4ub(90, 140, 250, 255), 3.0,
                  vg.StrokeFlags.ButtMiterAA)


def _layered(t):
    return lambda c, vg, _st: (_static_prefix(c, vg), _ui(c, vg, t))


@pytest.mark.parametrize("ss", [1, 2])
def test_layer_matches_full_path(ss):
    """An animated suffix over a stable prefix: one bake, then the suffix
    plan composites over the resident tiles (K2 form (b)'s twin)."""
    t = Trio(None, coverage_supersample=ss)
    for k in (0.0, 0.2, 0.4, 0.6):
        t.frame(_layered(k), bg=LBG)
    assert t.count("layer_bakes") == 1 and t.count("layer_hits") >= 3
    assert t.port._layer_used >= t.port.cfg.layer_min_prefix
    assert t.port._layer_render.shape == (
        t.port.last_plan.ntx * t.port.last_plan.nty, 8, 128, 4)


def test_layer_prefix_with_balanced_clip():
    def draw(k):
        def f(c, vg, _st):
            _static_prefix(c, vg, 18)
            vg.beginClip(c, 0)
            vg.beginPath(c)
            vg.rect(c, 120, 20, 100, 80)
            vg.fillPath(c, vg.Colors.White, vg.FillFlags.ConvexAA)
            vg.endClip(c)
            vg.beginPath(c)
            vg.circle(c, 170, 60, 45)
            vg.fillPath(c, vg.color4ub(250, 120, 40, 255), vg.FillFlags.ConvexAA)
            vg.resetClip(c)
            _ui(c, vg, k)
        return f

    t = Trio()
    for k in (0.0, 0.3, 0.6):
        t.frame(draw(k), bg=LBG)
    assert t.count("layer_hits") >= 2


def test_layer_cut_never_crosses_active_clip():
    def draw(k):
        def f(c, vg, _st):
            _static_prefix(c, vg, 20)
            vg.beginClip(c, 0)
            vg.beginPath(c)
            vg.rect(c, 100, 10, 140, 120)
            vg.fillPath(c, vg.Colors.White, vg.FillFlags.ConvexAA)
            vg.endClip(c)
            vg.beginPath(c)
            vg.circle(c, 150 + 40 * k, 70, 30)
            vg.fillPath(c, vg.color4ub(60, 220, 160, 255), vg.FillFlags.ConvexAA)
            vg.resetClip(c)
        return f

    t = Trio()
    for k in (0.0, 0.4, 0.8):
        t.frame(draw(k), bg=LBG)
    assert 0 < t.port._layer_used <= 20


def test_layer_invalidates_on_prefix_paint_change():
    def draw(col, k):
        def f(c, vg, _st):
            vg.beginPath(c)
            vg.rect(c, 5, 5, 80, 60)
            vg.fillPath(c, vg.color4ub(*col), vg.FillFlags.ConvexAA)
            _static_prefix(c, vg, 18)
            _ui(c, vg, k)
        return f

    t = Trio()
    for col, k in [((200, 40, 40, 255), 0.0), ((200, 40, 40, 255), 0.3),
                   ((200, 40, 40, 255), 0.5), ((40, 40, 200, 255), 0.7),
                   ((40, 40, 200, 255), 0.9)]:
        t.frame(draw(col, k), bg=LBG)
    assert t.count("layer_bakes") == 2


def test_layer_background_change_rebakes():
    t = Trio()
    for bg, k in ((LBG, 0.0), (LBG, 0.2), ((0.3, 0.1, 0.1, 1.0), 0.4),
                  ((0.3, 0.1, 0.1, 1.0), 0.6), ((0.3, 0.1, 0.1, 1.0), 0.6)):
        t.frame(_layered(k), bg=bg)
    assert t.count("layer_bakes") == 2


def test_layer_memo_and_paint_memo_compose():
    """Suffix-only paint deltas patch the suffix plan over the layer, an
    identical re-record is a memo hit with the layer still applied."""
    def draw(ui_col, k):
        def f(c, vg, _st):
            _static_prefix(c, vg, 20)
            _ui(c, vg, k)
            vg.beginPath(c)
            vg.rect(c, 250, 120, 40, 30)
            vg.fillPath(c, vg.color4ub(*ui_col), vg.FillFlags.ConvexAA)
        return f

    t = Trio()
    base = (120, 60, 200, 210)
    for k in (0.0, 0.25, 0.5):
        t.frame(draw(base, k), bg=LBG)
    assert t.count("layer_hits") >= 2
    for col in ((40, 220, 90, 210), (220, 90, 40, 210)):
        t.frame(draw(col, 0.5), bg=LBG)
    assert t.count("memo_paint_hits") == 2
    t.frame(draw((220, 90, 40, 210), 0.5), bg=LBG)
    assert t.count("memo_hits") == 1


@needs_font
def test_layer_with_text_and_texture_suffix():
    """Text in both prefix and suffix: the suffix plan's colour tiles
    reference suffix ops."""
    def draw(k):
        def f(c, vg, font):
            cfg = vg.makeTextConfig(c, font, 20.0, vg.TextAlign.BaselineLeft,
                                    vg.color4ub(240, 240, 240, 255))
            _static_prefix(c, vg, 18)
            vg.text(c, cfg, 10, 140, "static label")
            vg.text(c, cfg, 180 + 20 * k, 30, "moving")
            _ui(c, vg, k)
        return f

    t = Trio(_font)
    for k in (0.0, 0.5, 1.0):
        t.frame(draw(k), bg=LBG)
    assert t.count("layer_hits") >= 1


def test_layer_disabled_by_config():
    t = Trio(None, layer_memo=False)
    for k in (0.0, 0.3, 0.6):
        t.frame(_layered(k), bg=LBG)
    assert t.count("layer_hits") == 0 and t.port._layer_render is None
