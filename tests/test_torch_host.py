"""The port's jax-free copy of the host half (recorder, geometry, native
binner, fonts, numpy sampler, scenes) against vgtpu's: the same scene
recorded through both packages must give FramePlans that are equal bit for
bit — chunk pools, entry tables, pseudo-op tables, colour tiles and the
tile buckets."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's thread pool oversubscribed them by orders of magnitude
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
import vgtpu as vgj  # noqa: E402
import vgtpu_torch as vgt  # noqa: E402
from vgtpu_torch.fonts import UI_FONT  # noqa: E402

# the font the port ships (vgtpu's demo UI reads the same bytes from
# matplotlib's package data)
FONT_DATA = UI_FONT.read_bytes()


def _plan(vg, draw, w, h, dpr, ss=1):
    """Record through `vg`, then bin, sample textures and bucket tiles with
    that package's own host modules (both sample on the host:
    device_sampling=False)."""
    import importlib

    binning = importlib.import_module(f"{vg.__name__}.raster.binning")
    cfg = vg.ContextConfig(device_sampling=False, coverage_supersample=ss)
    if vg is vgj:
        ctx = vg.createContext(cfg)
    else:
        ctx = vg.createContext(cfg, device="cpu")
    cfg = ctx.cfg
    vg.begin(ctx, 0, w, h, dpr)
    draw(ctx, vg)
    ctx._finalize_ops()
    plan = binning.bin_frame(
        ctx.ops, ctx.fb_width, ctx.fb_height, tile_h=cfg.tile_h,
        tile_w=cfg.tile_w, chunk=cfg.edges_per_chunk, pools=cfg.chunk_pools,
        supersample=cfg.coverage_supersample,
        depth_cap=cfg.max_ops_per_tile_cap)
    ctx._fill_textures(plan)
    plan.tile_buckets = binning.compute_tile_buckets(
        plan.tile_entries, plan.tile_entries.shape[0], plan.entry_kind, plan)
    return plan


def _assert_same(a, b, path="plan"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def assert_plans_equal(pj, pt):
    fj, ft = dataclasses.asdict(pj), dataclasses.asdict(pt)
    assert sorted(fj) == sorted(ft)
    for k in fj:
        _assert_same(fj[k], ft[k], k)


def _small(ctx, vg):
    from vgtpu_torch.scenes.small import draw_small_scene

    draw_small_scene(ctx, FONT_DATA, vg=vg)


def _tiger_ui(ctx, vg):
    import importlib

    importlib.import_module(f"{vg.__name__}.scenes.demo_ui").draw_benchmark_frame(ctx, 0.0)


@pytest.mark.parametrize("scene,size,ss", [
    (_small, (512, 256, 1.0), 1),
    # the north-star frame's 1920x1080 canvas rendered at dpr 0.5 (960x540)
    (_tiger_ui, (1920, 1080, 0.5), 1),
    # the parity mode: sub-row geometry, (2,4,6,12,24) pools, colour tiles
    # on the output rows
    (_small, (512, 256, 1.0), 2),
    # the north-star frame itself, text included: chip_smoke.py [5] checks
    # the card's plan has vgtpu's entry count
    (_tiger_ui, (1920, 1080, 1.0), 1),
], ids=["small", "tiger_ui_half", "small_ss2", "tiger_ui_1080p"])
def test_plans_bit_identical(scene, size, ss):
    pj = _plan(vgj, scene, *size, ss=ss)
    pt = _plan(vgt, scene, *size, ss=ss)
    assert pt.supersample == ss and pt.tile_h == 8 * ss
    assert pt.n_real_entries > 0 and pt.color_tiles.shape[0] > 1
    assert_plans_equal(pj, pt)
    if size == (1920, 1080, 1.0):
        assert pj.stats["entries"] == chip_smoke.MAIN_ENTRIES


def test_plan_from_numpy_round_trips_vgtpu_plans():
    from vgtpu_torch.raster.binning import FramePlan, plan_from_numpy

    pj = _plan(vgj, _small, 512, 256, 1.0)
    pt = plan_from_numpy(dataclasses.asdict(pj))
    assert isinstance(pt, FramePlan)
    assert_plans_equal(pj, pt)
    pt.chunk_pools[0][0][:] = 7.0          # copies: vgtpu's plan is untouched
    assert not (pj.chunk_pools[0][0] == 7.0).all()
    with pytest.raises(ValueError, match="unknown FramePlan fields"):
        plan_from_numpy({**dataclasses.asdict(pj), "bogus": 1})
