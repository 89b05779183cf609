"""The port's device texture sampler (vgtpu_torch/ops/sampling_device.py) on
the CPU: ContextConfig.device_sampling=True against the numpy sampler
(device_sampling=False) and against vgtpu's device sampler, for text, rotated
text (the gather fallback), image patterns in four flag sets, a rotated
pattern, image updates, the colour-tile memo and the frame path's zero host
sampling.  The cases mirror tests/test_sampling_device.py, whose tolerance
(2e-5 against the numpy sampler) they keep, also against vgtpu's device
sampler; the sampler's colour tiles are held to vgtpu's on the same
sampling plan at 2e-6 (the port writes XLA's fused multiply-adds
explicitly)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores
torch.set_num_threads(1)

import vgtpu as vgj  # noqa: E402
import vgtpu_torch as vgt  # noqa: E402
from tests.fontdata import FONT_DATA  # noqa: E402

ATOL = 2e-5
needs_font = pytest.mark.skipif(FONT_DATA is None, reason="no test font")


def _render(vg, device_sampling: bool, draw, w=384, h=128, bg=(0, 0, 0, 0)):
    cfg = vg.ContextConfig(device_sampling=device_sampling)
    ctx = (vg.createContext(cfg, device="cpu") if vg is vgt
           else vg.createContext(cfg=cfg))
    vg.begin(ctx, 0, w, h, 1.0)
    draw(ctx, vg)
    out = vg.end(ctx, background=bg)
    return ctx, (out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out))


def _check(draw, w=384, h=128):
    """The port's device sampler against its numpy sampler and against
    vgtpu's device sampler, both within ATOL (vgtpu's test's tolerance)."""
    ctx, dev = _render(vgt, True, draw, w, h)
    assert isinstance(ctx.last_plan.color_tiles, torch.Tensor)
    _c, host = _render(vgt, False, draw, w, h)
    _c, ref = _render(vgj, True, draw, w, h)
    np.testing.assert_allclose(dev, host, atol=ATOL, rtol=0)
    np.testing.assert_allclose(dev, ref, atol=ATOL, rtol=0)
    return dev


def _text(ctx, vg):
    f = vg.createFont(ctx, "sans", FONT_DATA, len(FONT_DATA), 0)
    cfg = vg.makeTextConfig(ctx, f, 26.0, vg.TextAlign.MiddleLeft, vg.Colors.White)
    vg.text(ctx, cfg, 8, 40, "Device sampled text!")
    cfg2 = vg.makeTextConfig(ctx, f, 13.0, vg.TextAlign.MiddleLeft,
                             vg.color4ub(255, 160, 40, 200))
    vg.text(ctx, cfg2, 8, 90, "small translucent colored")


@needs_font
def test_text_device_sampling_matches_host():
    img = _check(_text)
    assert img[..., 3].max() > 0.5


@needs_font
def test_rotated_text_gather_fallback():
    def draw(ctx, vg):
        f = vg.createFont(ctx, "sans", FONT_DATA, len(FONT_DATA), 0)
        vg.transformTranslate(ctx, 190, 60)
        vg.transformRotate(ctx, 0.4)
        cfg = vg.makeTextConfig(ctx, f, 24.0, vg.TextAlign.MiddleCenter, vg.Colors.White)
        vg.text(ctx, cfg, 0, 0, "Rotated")

    _check(draw)


def _checker(n=64):
    img = np.zeros((n, n, 4), np.uint8)
    yy, xx = np.mgrid[0:n, 0:n]
    c = ((xx // 8 + yy // 8) % 2).astype(np.uint8)
    img[..., 0] = 255 * c
    img[..., 1] = 128
    img[..., 2] = 255 * (1 - c)
    img[..., 3] = 255
    return img


F = vgt.ImageFlags
PATTERN_FLAGS = [0, F.Clamp_U | F.Clamp_V, F.Filter_Nearest,
                 F.Filter_Nearest | F.Clamp_UV]


@pytest.mark.parametrize("flags", PATTERN_FLAGS,
                         ids=["repeat-linear", "clamp-linear", "repeat-nearest",
                              "clamp-nearest"])
def test_image_pattern_device_sampling(flags):
    img = _checker()

    def draw(ctx, vg):
        h = vg.createImage(ctx, 64, 64, flags, img)
        p = vg.createImagePattern(ctx, 40, 20, 96, 96, 0.0, h)
        vg.beginPath(ctx)
        vg.rect(ctx, 10, 10, 300, 100)
        vg.fillPath(ctx, p, vg.Colors.White, vg.FillFlags.ConvexAA)

    _check(draw)


def test_rotated_image_pattern_device_sampling():
    img = _checker()

    def draw(ctx, vg):
        h = vg.createImage(ctx, 64, 64, 0, img)
        p = vg.createImagePattern(ctx, 160, 60, 96, 96, 0.5, h)  # rotated
        vg.beginPath(ctx)
        vg.circle(ctx, 180, 64, 55)
        vg.fillPath(ctx, p, vg.Colors.White, vg.FillFlags.ConvexAA)

    _check(draw)


def test_device_sampling_tracks_image_updates():
    """updateImage between frames must invalidate the device texture."""
    img = _checker()
    ctx = vgt.createContext(vgt.ContextConfig(device_sampling=True), device="cpu")

    def frame():
        vgt.begin(ctx, 0, 128, 64, 1.0)
        p = vgt.createImagePattern(ctx, 0, 0, 64, 64, 0.0, h)
        vgt.beginPath(ctx)
        vgt.rect(ctx, 0, 0, 64, 64)
        vgt.fillPath(ctx, p, vgt.Colors.White, vgt.FillFlags.Convex)
        return vgt.end(ctx, background=(0, 0, 0, 1)).numpy().copy()

    vgt.begin(ctx, 0, 128, 64, 1.0)
    h = vgt.createImage(ctx, 64, 64, 0, img)
    vgt.end(ctx, background=(0, 0, 0, 1))

    a = frame()
    solid = np.full((64, 64, 4), 255, np.uint8)
    solid[..., 0] = 10
    solid[..., 1] = 200
    solid[..., 2] = 10
    vgt.updateImage(ctx, h, 0, 0, 64, 64, solid)
    b = frame()
    assert not np.allclose(a, b)
    assert b[32, 32, 1] > 0.7    # green now


@needs_font
def test_frame_path_has_zero_host_sampling(monkeypatch):
    """With device_sampling on, the host sampler must never run."""
    import vgtpu_torch.raster.sampling as hs

    def boom(*a, **k):  # pragma: no cover - should not be called
        raise AssertionError("host sampler called on device path")

    monkeypatch.setattr(hs, "fill_color_tiles", boom)

    def draw(ctx, vg):
        f = vg.createFont(ctx, "sans", FONT_DATA, len(FONT_DATA), 0)
        cfg = vg.makeTextConfig(ctx, f, 22.0, vg.TextAlign.MiddleLeft, vg.Colors.White)
        vg.text(ctx, cfg, 8, 32, "no host round-trip")

    _ctx, img = _render(vgt, True, draw)
    assert img[..., 3].max() > 0.5


def _pattern_frame(ctx, vg, h, moving_x=0.0):
    """An image pattern that stays put and a solid rect that moves."""
    p = vg.createImagePattern(ctx, 40, 20, 96, 96, 0.0, h)
    vg.beginPath(ctx)
    vg.rect(ctx, 10, 10, 200, 100)
    vg.fillPath(ctx, p, vg.Colors.White, vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.rect(ctx, 240 + moving_x, 20, 60, 40)
    vg.fillPath(ctx, vg.color4ub(200, 60, 40, 255), vg.FillFlags.ConvexAA)


def test_colour_tile_memo_hits_and_releases():
    """A frame whose sampling payload is unchanged reuses the resident
    colour tiles (ct_memo_hits, as vgtpu's _ct_memo); a whole frame that
    draws no texture releases them."""
    img = _checker()
    ctx = vgt.createContext(vgt.ContextConfig(frame_memo=False), device="cpu")
    vgt.begin(ctx, 0, 320, 128, 1.0)
    h = vgt.createImage(ctx, 64, 64, 0, img)
    imgs = []
    for k in range(3):
        vgt.begin(ctx, 0, 320, 128, 1.0)
        _pattern_frame(ctx, vgt, h, moving_x=3.0 * k)
        imgs.append(vgt.end(ctx).numpy().copy())
    assert ctx.profiler.counters.get("ct_memo_hits", 0) == 2
    assert len(ctx._ct_memo) == 1
    # the memo frames equal a fresh context's render of the last frame
    fresh = vgt.createContext(device="cpu")
    vgt.begin(fresh, 0, 320, 128, 1.0)
    h2 = vgt.createImage(fresh, 64, 64, 0, img)
    _pattern_frame(fresh, vgt, h2, moving_x=6.0)
    assert torch.equal(torch.from_numpy(imgs[2]), vgt.end(fresh))
    vgt.begin(ctx, 0, 320, 128, 1.0)
    vgt.beginPath(ctx)
    vgt.rect(ctx, 10, 10, 50, 50)
    vgt.fillPath(ctx, vgt.Colors.Red, vgt.FillFlags.ConvexAA)
    vgt.end(ctx)
    assert ctx._ct_memo == {}


def test_sampler_matches_vgtpu_on_one_plan():
    """sample_color_tiles_device on the same sampling plan (recorded and
    binned by vgtpu) as vgtpu's: the colour tiles within ATOL, including a
    rotated pattern (gather), A8-free RGBA patterns in every flag set, and
    duplicate tile ids from overlapping draws."""
    from vgtpu.ops.sampling_device import (
        build_sampling_plan as build_j,
        sample_color_tiles_device as sample_j,
    )
    from vgtpu.raster.binning import bin_frame
    from vgtpu_torch.ops.sampling_device import (
        build_sampling_plan,
        sample_color_tiles_device,
    )
    from vgtpu_torch.raster.binning import plan_from_numpy

    img = _checker()
    ctx = vgj.createContext(vgj.ContextConfig(device_sampling=False))
    vgj.begin(ctx, 0, 384, 128, 1.0)
    for i, flags in enumerate(PATTERN_FLAGS):
        hnd = vgj.createImage(ctx, 64, 64, flags, img)
        p = vgj.createImagePattern(ctx, 20 + 90 * i, 10, 40, 56, 0.0, hnd)
        vgj.beginPath(ctx)
        vgj.rect(ctx, 10 + 90 * i, 8, 80, 70)
        vgj.fillPath(ctx, p, vgj.Colors.White, vgj.FillFlags.ConvexAA)
    hnd = vgj.createImage(ctx, 64, 64, 0, img)
    p = vgj.createImagePattern(ctx, 200, 90, 64, 64, 0.7, hnd)
    vgj.beginPath(ctx)
    vgj.circle(ctx, 200, 90, 35)
    vgj.fillPath(ctx, p, vgj.color4ub(255, 255, 255, 180), vgj.FillFlags.ConvexAA)
    ctx._finalize_ops()
    plan_j = bin_frame(ctx.ops, 384, 128, tile_h=8, tile_w=128)
    plan_t = plan_from_numpy(dataclasses.asdict(plan_j))
    images = {i: (im.data, im.flags, im.generation) for i, im in ctx.images.items()}
    sp_j = build_j(plan_j, ctx.ops, images)
    sp_t = build_sampling_plan(plan_t, ctx.ops, images)
    assert np.array_equal(plan_j.entry_color_tile, plan_t.entry_color_tile)
    assert len(sp_t.groups) == len(sp_j.groups) >= 5
    assert any(not g.separable for g in sp_t.groups)
    for gj, gt in zip(sp_j.groups, sp_t.groups):
        assert np.array_equal(gj.params, gt.params) and np.array_equal(gj.ct, gt.ct)
    tex_j = ctx._device_textures(images, {g.image_id for g in sp_j.groups})
    tex_t = {k: torch.from_numpy(np.array(v)) for k, v in tex_j.items()}
    ref = np.asarray(sample_j(sp_j, tex_j, 8, 128))
    got = sample_color_tiles_device(sp_t, tex_t, 8, 128)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=0)


def test_plan_from_numpy_takes_device_colour_tiles():
    """plan_from_numpy copies colour tiles the device sampler left as a
    tensor back to numpy, so both halves still share one FramePlan."""
    from vgtpu_torch.raster.binning import plan_from_numpy

    ctx = vgt.createContext(device="cpu")
    vgt.begin(ctx, 0, 128, 64, 1.0)
    h = vgt.createImage(ctx, 64, 64, 0, _checker())
    _pattern_frame(ctx, vgt, h)
    vgt.end(ctx)
    plan = ctx.last_plan
    assert isinstance(plan.color_tiles, torch.Tensor)
    copy = plan_from_numpy(vars(plan))
    assert isinstance(copy.color_tiles, np.ndarray)
    np.testing.assert_array_equal(copy.color_tiles, plan.color_tiles.numpy())
