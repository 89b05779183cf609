"""The port's multi-GPU paths on CPU meshes, against vgtpu's on its virtual
CPU mesh (tests/conftest.py): the host partition, the tile-sharded frame
(kernel K4's twin + the oracle composite), the sharded fused frame (the
twins of K1, the fold and K2) and Mesh/make_mesh.

One plan feeds both halves (ROADMAP.md): recorded and binned by vgtpu,
handed to the port with plan_from_numpy; the partition reads the pools the
port's single-device frame uses (after raster/frame._prepare_plan), and
vgtpu's sharded frame is given the same dense arrays.  Tolerances: the
partition is integer bookkeeping, equal; the sharded frame 1e-5 and 1 u8
level (the oracle composites agree to a few ulps); the sharded fused frame
2e-6 against vgtpu (its Pallas kernels in interpret mode, as
tests/test_sharded_fused.py) and bit-equal to the port's own single-device
frame, whose adds it keeps in order."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores
torch.set_num_threads(1)

import vgtpu as vgj  # noqa: E402
from tests.fontdata import FONT_DATA  # noqa: E402
from vgtpu.raster.frame import image_to_u8 as image_to_u8_j  # noqa: E402
from vgtpu_torch.parallel.sharded_fused import render_frame_sharded_fused  # noqa: E402
from vgtpu_torch.parallel.sharding import (  # noqa: E402
    Mesh,
    make_mesh,
    partition_plan_for_mesh,
    plan_dense_arrays,
    render_frame_sharded,
)
from vgtpu_torch.raster.binning import plan_from_numpy  # noqa: E402
from vgtpu_torch.raster.frame import execute_plan_torch, image_to_u8  # noqa: E402


def cpu_mesh(n: int) -> Mesh:
    return Mesh((torch.device("cpu"),) * n)


def _plans(draw, w=256, h=128, ss=1, setup=None):
    """(vgtpu plan, port plan) of one recording: vgtpu records and bins,
    fills the colour tiles, and the port gets the numpy fields."""
    from vgtpu.raster.binning import bin_frame

    ctx = vgj.createContext(vgj.ContextConfig(device_sampling=False,
                                              coverage_supersample=ss))
    st = setup(ctx) if setup else None
    vgj.begin(ctx, 0, w, h, 1.0)
    draw(ctx, st)
    ctx._finalize_ops()
    cfg = ctx.cfg
    plan_j = bin_frame(ctx.ops, w, h, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                       supersample=ss)   # tiles of tile_h * ss sub-rows
    ctx._fill_textures(plan_j)
    return plan_j, plan_from_numpy(dataclasses.asdict(plan_j))


# ---- scenes (tests/test_parallel.py's) ---------------------------------------

def _basic(ctx, _st=None):
    vg = vgj
    vg.beginPath(ctx)
    vg.circle(ctx, 80, 60, 40)
    vg.fillPath(ctx, vg.color4ub(200, 60, 30, 255), vg.FillFlags.ConvexAA)
    g = vg.createLinearGradient(ctx, 120, 0, 250, 0, vg.Colors.Red, vg.Colors.Blue)
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 130, 20, 110, 80, 12)
    vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)
    vg.beginPath(ctx)
    vg.moveTo(ctx, 20, 100)
    vg.lineTo(ctx, 120, 110)
    vg.strokePath(ctx, vg.Colors.Black, 5.0, vg.StrokeFlags.RoundRoundAA)


def _clips(ctx, _st=None):
    vg = vgj
    vg.beginClip(ctx, vg.ClipRule.In)
    vg.beginPath(ctx)
    vg.circle(ctx, 90, 64, 50)
    vg.fillPath(ctx, vg.Colors.White, vg.FillFlags.ConvexAA)
    vg.endClip(ctx)
    vg.beginPath(ctx)
    vg.rect(ctx, 20, 20, 150, 90)
    vg.fillPath(ctx, vg.color4ub(40, 180, 220, 255), vg.FillFlags.ConvexAA)
    vg.resetClip(ctx)
    vg.beginClip(ctx, vg.ClipRule.Out)
    vg.beginPath(ctx)
    vg.rect(ctx, 170, 30, 60, 60)
    vg.fillPath(ctx, vg.Colors.White, vg.FillFlags.ConvexAA)
    vg.endClip(ctx)
    vg.beginPath(ctx)
    vg.circle(ctx, 200, 64, 45)
    vg.fillPath(ctx, vg.color4ub(230, 120, 40, 200), vg.FillFlags.ConvexAA)
    vg.resetClip(ctx)


def _text_setup(ctx):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 255, (32, 32, 4), np.uint8)
    img[..., 3] = 255
    return (vgj.createImage(ctx, 32, 32, 0, img),
            vgj.createFont(ctx, "sans", FONT_DATA, len(FONT_DATA), 0))


def _text_and_pattern(ctx, st):
    vg = vgj
    h_img, f = st
    p = vg.createImagePattern(ctx, 10, 10, 96, 96, 0.0, h_img)
    vg.beginPath(ctx)
    vg.rect(ctx, 10, 10, 120, 100)
    vg.fillPath(ctx, p, vg.Colors.White, vg.FillFlags.ConvexAA)
    cfg = vg.makeTextConfig(ctx, f, 22.0, vg.TextAlign.BaselineLeft,
                            vg.color4ub(250, 240, 40, 255))
    vg.text(ctx, cfg, 120, 60, "shard me")


def _bow_tie(ctx, _st=None):
    vg = vgj
    vg.beginPath(ctx)
    vg.moveTo(ctx, 30, 20)
    vg.lineTo(ctx, 220, 100)
    vg.lineTo(ctx, 30, 100)
    vg.lineTo(ctx, 220, 20)
    vg.closePath(ctx)
    vg.fillPath(ctx, vg.color4ub(200, 60, 200, 230), vg.FillFlags.ConcaveEvenOddAA)
    _basic(ctx)


def _trilist(ctx, _st=None):
    pos = np.array([[20, 20], [240, 30], [130, 110], [30, 115]], np.float32)
    colors = np.array([0xFF0000FF, 0xFF00FF00, 0xFFFF0000, 0xFF00FFFF], np.uint32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    vgj.indexedTriList(ctx, pos, None, 4, colors, 4, idx, 6, None)


def _uneven(ctx, _st=None):
    _basic(ctx)
    vgj.beginPath(ctx)
    vgj.circle(ctx, 330, 90, 30)
    vgj.fillPath(ctx, vgj.color4ub(90, 220, 90, 255), vgj.FillFlags.ConvexAA)


def _close_u8(got, ref, atol):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    u8 = np.abs(image_to_u8(got).astype(np.int16)
                - image_to_u8_j(ref).astype(np.int16)).max()
    assert u8 <= 1, f"{u8} u8 levels"


# ---- (a) the host partition ------------------------------------------------

@pytest.fixture(scope="module")
def text_plans():
    if FONT_DATA is None:
        pytest.skip("no test font available")
    return _plans(_text_and_pattern, setup=_text_setup)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_partition_matches_vgtpu(text_plans, n):
    from vgtpu.parallel.sharding import partition_plan_for_mesh as partition_j

    plan_j, plan_t = text_plans
    d = plan_dense_arrays(plan_t)
    arrays_t, meta_t = partition_plan_for_mesh(d, plan_t, n)
    arrays_j, meta_j = partition_j(d, plan_j, n)
    assert arrays_t.keys() == arrays_j.keys() and meta_t.keys() == meta_j.keys()
    for k in arrays_j:
        if k == "chunk_pools":
            assert len(arrays_t[k]) == len(arrays_j[k])
            for (ce_t, cent_t), (ce_j, cent_j) in zip(arrays_t[k], arrays_j[k]):
                np.testing.assert_array_equal(ce_t, ce_j)
                np.testing.assert_array_equal(cent_t, cent_j)
        else:
            np.testing.assert_array_equal(arrays_t[k], arrays_j[k], err_msg=k)
    for k in meta_j:
        if k == "pool_maps":
            for pm_t, pm_j in zip(meta_t[k], meta_j[k], strict=True):
                np.testing.assert_array_equal(pm_t[0], pm_j[0])
                np.testing.assert_array_equal(pm_t[1], pm_j[1])
                assert pm_t[2] == pm_j[2]
        elif isinstance(meta_j[k], np.ndarray):
            np.testing.assert_array_equal(meta_t[k], meta_j[k], err_msg=k)
        else:
            assert meta_t[k] == meta_j[k], k
    assert meta_t["ici_bytes_per_frame"] == 0


# ---- (b) the tile-sharded frame ---------------------------------------------

SHARDED_CASES = {
    "basic": dict(draw=_basic, bg=(1, 1, 1, 1)),
    "clips": dict(draw=_clips, bg=(0.2, 0.2, 0.25, 1)),
    "text_pattern": dict(draw=_text_and_pattern, setup=_text_setup, bg=(0, 0, 0, 1)),
    "bow_tie_ss4": dict(draw=_bow_tie, ss=4, bg=(1, 1, 1, 1)),
    "trilist": dict(draw=_trilist, bg=(0.1, 0.1, 0.1, 1)),
    "uneven_384x104": dict(draw=_uneven, w=384, h=104, bg=(1, 1, 1, 1)),
}


@pytest.mark.parametrize("case,n", [("basic", 2), ("basic", 8)]
                         + [(c, 4) for c in SHARDED_CASES])
def test_sharded_frame_matches_vgtpu(case, n):
    from vgtpu.parallel.sharding import make_mesh as make_mesh_j
    from vgtpu.parallel.sharding import render_frame_sharded as render_j

    spec = SHARDED_CASES[case]
    if spec.get("setup") and FONT_DATA is None:
        pytest.skip("no test font available")
    plan_j, plan_t = _plans(spec["draw"], spec.get("w", 256), spec.get("h", 128),
                            spec.get("ss", 1), spec.get("setup"))
    if case == "uneven_384x104":
        assert (plan_t.ntx * plan_t.nty) % n != 0
    assert plan_t.supersample == spec.get("ss", 1)
    assert plan_t.tile_h == 8 * plan_t.supersample
    img, meta = render_frame_sharded(plan_t, cpu_mesh(n), spec["bg"],
                                     return_meta=True)
    assert img.device.type == "cpu" and meta["ici_bytes_per_frame"] == 0
    # vgtpu's sharded frame on the same dense arrays (the port's pools)
    ref = np.asarray(render_j(plan_j, plan_dense_arrays(plan_t), make_mesh_j(n),
                              background=spec["bg"]))
    _close_u8(img, ref, atol=1e-5)
    # and the port's own single-device frame of the plan
    single = execute_plan_torch(plan_t, spec["bg"], device="cpu")
    _close_u8(img, single.numpy(), atol=1e-5)


# ---- (c) the sharded fused frame --------------------------------------------

@pytest.fixture(scope="module", params=[1, 2], ids=["ss1", "ss2"])
def fused_plans(request):
    """tests/test_sharded_fused.py's scene and plan; the port's copy without
    the resolve split, the RAW formulation both sharded paths take."""
    from tests.test_sharded_fused import _plan_and_d

    plan_j, d_j = _plan_and_d(ss=request.param)
    plan_t = plan_from_numpy(dataclasses.asdict(plan_j))
    plan_t.resolve_host = {}          # the unsplit single-device frame
    return plan_j, d_j, plan_t


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_fused_matches_vgtpu(fused_plans, n):
    from vgtpu.parallel.sharded_fused import render_frame_sharded_fused as fused_j
    from vgtpu.parallel.sharding import make_mesh as make_mesh_j

    plan_j, d_j, plan_t = fused_plans
    bg = (0.1, 0.2, 0.3, 1.0)
    img, meta = render_frame_sharded_fused(plan_t, cpu_mesh(n), bg, return_meta=True)
    assert meta["ici_bytes_per_frame"] == 0
    ref = np.asarray(fused_j(plan_j, d_j, make_mesh_j(n), background=bg))
    np.testing.assert_allclose(img.numpy(), ref, atol=2e-6, rtol=0)
    single = execute_plan_torch(plan_t, bg, device="cpu")
    assert torch.equal(img, single)


# ---- (d) Mesh and make_mesh --------------------------------------------------

def test_make_mesh_takes_cards_and_never_wraps(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh(2).devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh().size == 2
    with pytest.raises(RuntimeError, match="2 CUDA device"):
        make_mesh(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="0 CUDA device"):
        make_mesh()
    with pytest.raises(ValueError, match="no devices"):
        Mesh(())


def test_repeated_device_mesh_renders_like_one_shard():
    """Four shards on one device (the one-card layout): the same image as
    one shard, and the partition's balance over four."""
    _plan_j, plan_t = _plans(_uneven, 384, 104)
    mesh = Mesh(("cpu",) * 4)
    assert mesh.devices == (torch.device("cpu"),) * 4 and mesh.size == 4
    one = render_frame_sharded(plan_t, cpu_mesh(1))
    four, meta = render_frame_sharded(plan_t, mesh, return_meta=True)
    assert len(meta["entries_per_dev"]) == 4
    assert torch.equal(one, four)
