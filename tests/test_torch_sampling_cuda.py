"""Kernel S1 (csrc/sample_tiles.cu) against its twin on a CUDA card.

Every test here needs a card and skips without one (marker `card`, as in
vgbench/tests).  They import no JAX; run them on a machine with a card,
without the suite's conftest.py (which imports JAX):

    python -m pytest --noconftest -m card tests/test_torch_sampling_cuda.py

The tolerance is 1e-5 on colour tiles in [0, 1]: S1 computes the twin's
weights and texel coordinates with the same float32 roundings and sums two
taps where the twin's matrix products sum the whole texture row of mostly
zero weights, so the two differ by a few float32 ulps of the summation
order (tests/test_torch_sampling_index.py shows the same function on the
CPU within 2e-6).
"""

from __future__ import annotations

import pytest
import torch
from test_torch_sampling_index import FLAG_SETS, random_plan, twin_flat

from vgtpu_torch.core import ImageFlags
from vgtpu_torch.ops.sampling_device import sample_tiles_flat, upload_groups
from vgtpu_torch.raster.binning import P_IMAGE, P_TEXTURE

pytestmark = pytest.mark.card

S1_BOUND = 1e-5
TH, TW = 8, 128


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel S1 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _launches():
    from vgtpu_torch.ops.sampling_cuda import S1

    return S1.launches


@pytest.mark.parametrize("flags", FLAG_SETS)
@pytest.mark.parametrize("kind, sep", [(P_TEXTURE, True), (P_TEXTURE, False),
                                       (P_IMAGE, True), (P_IMAGE, False)])
@pytest.mark.parametrize("channels", [1, 4])
def test_s1_matches_the_twin_on_every_group_form(card, flags, kind, sep, channels):
    """Synthetic groups of every form (textured quads or patterns,
    separable or rotated, nearest or bilinear, clamp or repeat per axis, A8
    or RGBA), over tiles shared by two groups, an empty tile and pad rows,
    at residuals near 0 and near a tile."""
    seed = hash((flags, kind, sep, channels)) % 2**31
    sp, texs = random_plan(seed, kind, sep, flags, channels)
    for texture in (None, (512, 512)):
        if texture is not None:
            sp, texs = random_plan(seed, kind, sep, flags, channels, texture=texture)
        g = upload_groups(sp, [t.to(card) for t in texs], card, (TH, TW))
        for shift in ((0.0, 0.0), (0.004, 0.5), (7.37, 3.0), (127.996, 7.5)):
            n0 = _launches()
            got = sample_tiles_flat(g, shift=shift)
            want = sample_tiles_flat(g, shift=shift, plain=True)
            torch.cuda.synchronize()
            assert _launches() == n0 + 1
            err = float((got - want).abs().max())
            assert err <= S1_BOUND, (texture, shift, err)
            assert not got[-1].any()
            cpu = twin_flat(upload_groups(sp, texs, torch.device("cpu"), (TH, TW)),
                            TH, TW, shift)
            assert float((got.cpu() - cpu).abs().max()) <= S1_BOUND


@pytest.mark.parametrize("th, tw", [(16, 256), (3, 100)])
@pytest.mark.parametrize("kind, sep", [(P_TEXTURE, True), (P_TEXTURE, False),
                                       (P_IMAGE, True), (P_IMAGE, False)])
def test_s1_matches_the_twin_on_other_tile_shapes(card, th, tw, kind, sep):
    """Tiles of more pixels than S1 sums in shared memory at once (16 x 256:
    two passes over the tile) and of an odd shape (3 x 100: one partial
    pass), bilinear and repeat, A8 and RGBA."""
    seed = hash((th, tw, kind, sep)) % 2**31
    for channels in (1, 4):
        sp, texs = random_plan(seed, kind, sep, ImageFlags.Filter_Bilinear, channels)
        g = upload_groups(sp, [t.to(card) for t in texs], card, (th, tw))
        for shift in ((0.0, 0.0), (7.37, 0.5), (127.9, 3.0)):
            got = sample_tiles_flat(g, shift=shift)
            want = sample_tiles_flat(g, shift=shift, plain=True)
            assert got.shape == (sp.num_tiles + 1, 4 * th * tw)
            err = float((got - want).abs().max())
            assert err <= S1_BOUND, (channels, shift, err)
            assert not got[-1].any()


def _scroll_scene(ss: int, card):
    """The 1080p tiger + demo-UI frame baked over 2560x1440, the scroll
    cells' scene."""
    import vgtpu_torch as vg
    from vgtpu_torch.raster.retained import RetainedScene
    from vgtpu_torch.scenes import demo_ui

    c = vg.createContext(vg.ContextConfig(coverage_supersample=ss), device=card.type)
    vg.begin(c, 0, 1920, 1080, 1.0)
    demo_ui.draw_benchmark_frame(c, 0.0)
    return RetainedScene.bake(c, 2560, 1440)


@pytest.mark.parametrize("ss", [1, 2])
def test_s1_matches_the_twin_on_the_scroll_scene(card, ss):
    """The glyph quads of the scroll cells' scene, resampled as the pan
    resamples them, at x residuals near 0 and near 128 and whole sub-rows;
    one S1 launch a view, counted as sample_kernel_launches."""
    scene = _scroll_scene(ss, card)
    samp = scene.d["samp"]
    assert samp.words.is_cuda and samp.n_pairs > 0
    assert samp.tile == (scene.tile_h // ss, scene.tile_w)
    worst = 0.0
    for rx, ry in ((0.0, 0), (0.0001, 1), (7.37, ss), (63.5, 2 * ss - 1),
                   (127.99, 0), (127.9999, 3)):
        got = sample_tiles_flat(samp, shift=(rx, ry / ss))
        want = sample_tiles_flat(samp, shift=(rx, ry / ss), plain=True)
        worst = max(worst, float((got - want).abs().max()))
    assert worst <= S1_BOUND
    prof = scene.profiler
    n0 = prof.counters.get("sample_kernel_launches", 0)
    scene.render(37.25, 5.0)
    scene.render(1.5, 0.0, use_pallas=False)
    assert prof.counters.get("sample_kernel_launches", 0) == n0 + 1


def test_s1_matches_the_twin_on_a_city_map_bake(card):
    """A 1024 x 768 region of the map cell's city (its densities, dense
    rotated labels), baked as the cell bakes it: S1 against the twin at
    residuals of 0, a fraction and whole rows; each view adds the bake's
    footprint count to sample_footprint_px, more than 0 and below every
    pair's whole tile, so S1 culled."""
    import vgtpu_torch as vg
    from vgtpu_torch.raster.retained import RetainedScene
    from vgtpu_torch.scenes.citymap import draw_city

    c = vg.createContext(vg.ContextConfig(coverage_supersample=1, tile_w=TW, tile_h=TH,
                                          device_sampling=True), device=card.type)
    vg.begin(c, 0, 480, 270, 1.0)
    draw_city(c, 1, 1024, 768)
    scene = RetainedScene.bake(c, 1024, 768)
    samp = scene.d["samp"]
    assert samp.words.is_cuda and samp.n_pairs > 0 and samp.n_rotated_pairs > 0
    for shift in ((0.0, 0.0), (37.3, 3.0), (100.5, 6.0)):
        got = sample_tiles_flat(samp, shift=shift)
        want = sample_tiles_flat(samp, shift=shift, plain=True)
        err = float((got - want).abs().max())
        assert err <= S1_BOUND, (shift, err)
        assert got[:-1].any() and not got[-1].any()
    prof = scene.profiler
    n0 = prof.counters.get("sample_footprint_px", 0)
    scene.render(37.25, 3.0)
    fp = prof.counters["sample_footprint_px"] - n0
    assert fp == samp.footprint_px
    assert 0 < fp < samp.n_pairs * TH * TW


def test_s1_matches_the_twin_on_the_pattern_panels(card):
    """The frame path: chip_smoke.py [10a]'s pattern panels (separable
    patterns in every (wrap, filter) pair and a rotated, nearest, clamped
    one) and the UI's text through end() with device sampling: the colour
    tiles S1 wrote against the twin on the CPU, one S1 launch on the memo's
    miss and none on its hit."""
    import vgtpu_torch as vg
    from vgtpu_torch.ops.sampling_device import build_sampling_plan, sample_color_tiles_device
    from vgtpu_torch.scenes import demo_ui
    from vgtpu_torch.scenes.small import draw_pattern_panels, make_pattern_images

    c = vg.createContext(vg.ContextConfig(frame_memo=False), device="cuda")
    images = make_pattern_images(c)
    c.profiler.reset()

    def frame():
        vg.begin(c, 0, 1920, 1080, 1.0)
        demo_ui.draw_benchmark_frame(c, 0.0)
        draw_pattern_panels(c, images)
        return vg.end(c)

    frame()
    assert c.profiler.counters["sample_kernel_launches"] == 1
    ct = c.last_plan.color_tiles
    assert ct.is_cuda
    vg.begin(c, 0, 1920, 1080, 1.0)
    demo_ui.draw_benchmark_frame(c, 0.0)
    draw_pattern_panels(c, images)
    c._finalize_ops()
    image_map = {i: (im.data, im.flags, im.generation) for i, im in c.images.items()}
    image_map.update(c.font_system.atlas_image_map())
    sp = build_sampling_plan(c.last_plan, c.ops, image_map)
    assert {g.kind for g in sp.groups} == {P_IMAGE, P_TEXTURE}
    assert any(not g.separable for g in sp.groups)
    tex = c._device_textures(image_map, {g.image_id for g in sp.groups})
    want = sample_color_tiles_device(sp, {k: v.cpu() for k, v in tex.items()}, TH, TW)
    assert float((ct.cpu() - want).abs().max()) <= S1_BOUND
    frame()
    assert c.profiler.counters["sample_kernel_launches"] == 1
    assert c.profiler.counters["ct_memo_hits"] == 1
