"""The port end to end on the CPU: vg.end() of vgtpu_torch against vgtpu's on
the same scene, the package importing with jax blocked, the entry points
that must refuse (no CUDA) and those that once refused (command lists).

vgtpu renders through its XLA scan on the CPU and the port through the
fused formulation; tests/test_composite_pallas.py shows the two agree to
2e-6, so the images are held to atol=1e-5 and to 1 u8 level after
image_to_u8."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's thread pool oversubscribed them by orders of magnitude
torch.set_num_threads(1)

import vgtpu as vgj  # noqa: E402
import vgtpu_torch as vgt  # noqa: E402
from tests.fontdata import FONT_DATA  # noqa: E402
from vgtpu.raster.frame import image_to_u8 as image_to_u8_j  # noqa: E402
from vgtpu_torch.raster.frame import image_to_u8  # noqa: E402
from vgtpu_torch.raster.retained import PendingPanLayer  # noqa: E402
from vgtpu_torch.scenes.small import HEIGHT, WIDTH, draw_small_scene  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BG = (0.9, 0.9, 0.95, 1.0)


def test_end_matches_vgtpu_small_scene():
    ctx_j = vgj.createContext(vgj.ContextConfig(device_sampling=False))
    vgj.begin(ctx_j, 0, WIDTH, HEIGHT, 1.0)
    draw_small_scene(ctx_j, FONT_DATA, vg=vgj)
    ref = np.asarray(vgj.end(ctx_j, background=BG))

    ctx = vgt.createContext(device="cpu")
    vgt.begin(ctx, 0, WIDTH, HEIGHT, 1.0)
    draw_small_scene(ctx, FONT_DATA)
    img = vgt.end(ctx, background=BG)
    assert isinstance(img, torch.Tensor)
    assert img.shape == (HEIGHT, WIDTH, 4) and img.dtype == torch.float32
    assert img.device.type == "cpu"
    np.testing.assert_allclose(img.numpy(), ref, atol=1e-5, rtol=0)
    u8 = image_to_u8(img).astype(np.int16)
    assert np.abs(u8 - image_to_u8_j(ref).astype(np.int16)).max() <= 1


def test_second_frame_and_plain_path_agree():
    """Two frames of the same scene render the same image (the scene makes
    a new image each frame, so the second takes the full path too);
    execute_plan and the plain execute_plan_torch are the same computation
    on the CPU."""
    from vgtpu_torch.raster.frame import execute_plan, execute_plan_torch

    ctx = vgt.createContext(device="cpu")
    imgs = []
    for _ in range(2):
        vgt.begin(ctx, 0, WIDTH, HEIGHT, 1.0)
        draw_small_scene(ctx)
        imgs.append(vgt.end(ctx))
    assert torch.equal(imgs[0], imgs[1])
    d = ctx.last_device_arrays
    a = execute_plan(ctx.last_plan, (1, 1, 1, 1), device_arrays=d)
    b = execute_plan_torch(ctx.last_plan, (1, 1, 1, 1), device_arrays=d)
    assert torch.equal(a, b) and torch.equal(a, imgs[1])


def test_plan_upload_rejects_out_of_range_tile_ids():
    """Indices from the host binner are checked before any kernel sees
    them: the kernels index without bounds checks."""
    from vgtpu_torch.raster.frame import plan_host_arrays

    ctx = vgt.createContext(device="cpu")
    vgt.begin(ctx, 0, WIDTH, HEIGHT, 1.0)
    draw_small_scene(ctx)
    vgt.end(ctx)
    plan = ctx.last_plan
    plan.tile_buckets[0][1][0] = plan.ntx * plan.nty + 1
    with pytest.raises(ValueError, match="outside the framebuffer"):
        plan_host_arrays(plan)


def test_port_imports_and_renders_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import vgtpu_torch as vg\n"
        "from vgtpu_torch.scenes.small import draw_small_scene\n"
        "ctx = vg.createContext(device='cpu')\n"
        "vg.begin(ctx, 0, 512, 256, 1.0)\n"
        "draw_small_scene(ctx)\n"
        "img = vg.end(ctx)\n"
        "assert img.shape == (256, 512, 4) and bool(torch.isfinite(img).all())\n"
        "assert float(img[..., 3].min()) > 0.99\n"
        "ctx = vg.createContext(vg.ContextConfig(coverage_supersample=2), device='cpu')\n"
        "vg.begin(ctx, 0, 512, 256, 1.0)\n"
        "draw_small_scene(ctx)\n"
        "img = vg.end(ctx)\n"
        "assert img.shape == (256, 512, 4) and bool(torch.isfinite(img).all())\n"
        "assert ctx.last_device_arrays['res'] is not None\n"
        "def scene(c, col):\n"
        "    vg.beginPath(c); vg.rect(c, 10, 10, 200, 100)\n"
        "    vg.fillPath(c, vg.color4ub(*col, 200), vg.FillFlags.ConvexAA)\n"
        "ctx = vg.createContext(device='cpu')\n"
        "for col in ((200, 40, 40), (200, 40, 40), (40, 200, 40)):\n"
        "    vg.begin(ctx, 0, 256, 128, 1.0); scene(ctx, col); img = vg.end(ctx)\n"
        "n = ctx.profiler.counters\n"
        "assert n['memo_hits'] == 1 and n['memo_paint_hits'] == 1, dict(n)\n"
        "vb = vg.VariantBatch.bake(ctx, [lambda c, k=k: scene(c, (40 * k, 90, 90))\n"
        "                                for k in range(3)], 256, 128)\n"
        "imgs = vb.render()\n"
        "assert imgs.shape == (3, 128, 256, 4) and bool(torch.isfinite(imgs).all())\n"
        "from vgtpu_torch.parallel.sharding import Mesh, render_frame_sharded\n"
        "mesh = Mesh(('cpu',) * 2)\n"
        "assert float((vb.render_sharded(mesh) - imgs).abs().max()) < 1e-5\n"
        "img = render_frame_sharded(ctx.last_plan, mesh, ctx.background)\n"
        "assert img.shape == (128, 256, 4) and bool(torch.isfinite(img).all())\n"
        "from vgtpu_torch.ops.composite import composite_bucket_flat\n"
        "from vgtpu_torch.ops.coverage import coverage_chunks, coverage_chunks_t\n"
        "from vgtpu_torch.ops import composite_flat_cuda, coverage_slots_cuda\n"
        "from vgtpu_torch.ops import coverage_t_flat_cuda, probe_cuda\n"
        "from vgtpu_torch.utils.cold_probe import probe_affine\n"
        "e = torch.zeros((4, 2, 4)); e[:, 0] = torch.tensor([1.0, -1.0, 5.0, 9.0])\n"
        "cov = coverage_chunks(e, 8, 128)\n"
        "assert torch.equal(coverage_chunks_t(e, 8, 128, variant='flat'), cov.reshape(4, -1).t())\n"
        "fb = composite_bucket_flat(cov.reshape(1, 1024, 4), torch.zeros((1, 40, 4)), None,\n"
        "                           torch.ones((4096, 1)), tile_w=128, flags=(False,) * 7)\n"
        "assert fb.shape == (4096, 4)\n"
        "assert torch.equal(probe_affine(torch.ones(3)), torch.full((3,), 3.0))\n"
        "from vgtpu_torch.api import command_list, standalone\n"
        "from vgtpu_torch.helpers import vgpp\n"
        "from vgtpu_torch import diff\n"
        "from vgtpu_torch.ops import flatten\n"
        "from vgtpu_torch.utils.profiler import trace_frame\n"
        "ctx = vg.createContext(device='cpu')\n"
        "cl = vg.createCommandList(ctx, vg.CommandListFlags.Cacheable)\n"
        "vg.beginCommandList(ctx, cl); scene(ctx, (90, 90, 200)); vg.endCommandList(ctx)\n"
        "for k in range(5):\n"
        "    vg.begin(ctx, 0, 256, 128, 1.0); vg.pushState(ctx)\n"
        "    vg.transformTranslate(ctx, 3 * k, 2 * k); vg.submitCommandList(ctx, cl)\n"
        "    vg.popState(ctx); img = vg.end(ctx)\n"
        "assert ctx.profiler.counters['layer_cl_hits'] == 2, dict(ctx.profiler.counters)\n"
        "r = vgpp.Renderer(device='cpu'); r.begin_frame(64, 32)\n"
        "assert r.end_frame().shape == (32, 64, 4)\n"
        "m = vg.strokerConvexFill(vg.createStroker(), None, np.array([[0, 0], [8, 0], [8, 8]], np.float32), 3)\n"
        "assert m.pos.shape == (3, 2)\n"
        "e = diff.polygon_edges(torch.tensor([[2.0, 2.0], [12.0, 3.0], [6.0, 12.0]]))\n"
        "img = diff.render_edges(e, torch.ones((1, 4)), torch.zeros(3, dtype=torch.long), 16, 16)\n"
        "assert img.shape == (16, 16, 4) and float(img[..., 3].max()) == 1.0\n"
        "cp = torch.tensor([[[0.0, 0.0], [10.0, 20.0], [20.0, -20.0], [30.0, 0.0]]])\n"
        "assert flatten.flatten_cubics(cp, 0.5, max_n=16).shape == (1, 17, 2)\n"
        "bad = [m for m in sys.modules if m == 'vgtpu' or m.startswith('vgtpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_create_context_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vgt.createContext()
    with pytest.raises(ValueError, match="unsupported device"):
        vgt.createContext(device="meta")
    assert vgt.createContext(device="cpu").device == torch.device("cpu")


def _command_list_created(ctx):
    h = vgt.createCommandList(ctx, 0)
    assert h.idx in ctx.command_lists and vgt.isValid(h)


def _cl_begin_path_recorded(ctx):
    h = vgt.createCommandList(ctx, 0)
    vgt.clBeginPath(ctx, h)
    vgt.clRect(ctx, h, 8, 8, 16, 16)
    vgt.clFillPath(ctx, h, vgt.Colors.White, vgt.FillFlags.ConvexAA)
    assert [c[0] for c in ctx.command_lists[h.idx].commands] == [
        "beginPath", "rect", "fillPath"]
    assert not ctx.ops
    vgt.submitCommandList(ctx, h)
    assert len(ctx.ops) == 1


def _pending_pan_layer_renders(ctx):
    from vgtpu_torch.raster.retained import RetainedScene

    vgt.beginPath(ctx)
    vgt.rect(ctx, 8, 8, 16, 16)
    vgt.fillPath(ctx, vgt.Colors.White, vgt.FillFlags.ConvexAA)
    scene = RetainedScene.bake(ctx, background=(0.0, 0.0, 0.0, 1.0))
    layer = PendingPanLayer(scene, (3, 2), (0.0, 0.0, 0.0, 1.0))
    tiles = layer.materialize()
    assert torch.equal(tiles, scene.render_tiles(3, 2, (0.0, 0.0, 0.0, 1.0)))


@pytest.mark.parametrize("call", [
    _command_list_created, _cl_begin_path_recorded, _pending_pan_layer_renders,
], ids=["createCommandList", "clBeginPath", "PendingPanLayer"])
def test_unported_entry_points_raise(call):
    """These entry points raised NotImplementedError until command lists
    and the cached-list pan layer were ported; each case now checks that
    the call works."""
    ctx = vgt.createContext(device="cpu")
    vgt.begin(ctx, 0, 64, 64, 1.0)
    call(ctx)


def _ss_scene(ctx, vg, font_data):
    """A 256x128 scene for the supersampled path: clip, scissor, both fill
    rules, non-AA, a gradient, an image pattern, text, a large translucent
    fill (chunkless interiors) and a dense zig-zag (a multi-chunk entry)."""
    g = vg.createLinearGradient(ctx, 5, 5, 120, 70, vg.Colors.Red, vg.Colors.Blue)
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 5, 5, 115, 65, 12)
    vg.fillPath(ctx, g, vg.FillFlags.ConvexAA)
    ang = -np.pi / 2 + np.arange(5) * (4 * np.pi / 5)
    vg.beginPath(ctx)
    vg.moveTo(ctx, 200 + 40 * np.cos(ang[0]), 50 + 40 * np.sin(ang[0]))
    for a in ang[1:]:
        vg.lineTo(ctx, 200 + 40 * np.cos(a), 50 + 40 * np.sin(a))
    vg.closePath(ctx)
    vg.fillPath(ctx, vg.color4ub(40, 220, 120, 200), vg.FillFlags.ConcaveEvenOddAA)
    vg.setScissor(ctx, 13, 33, 181, 61)
    vg.beginPath(ctx)
    vg.rect(ctx, -10, 20, 280, 100)
    vg.fillPath(ctx, vg.color4ub(20, 40, 90, 120), vg.FillFlags.ConvexAA)
    vg.resetScissor(ctx)
    vg.beginClip(ctx, vg.ClipRule.Out)
    vg.beginPath(ctx)
    vg.circle(ctx, 70, 95, 25)
    vg.fillPath(ctx, vg.Colors.Black, vg.FillFlags.Convex)
    vg.endClip(ctx)
    vg.beginPath(ctx)
    vg.rect(ctx, 30, 75, 90, 45)
    vg.fillPath(ctx, vg.color4ub(230, 90, 30, 255), vg.FillFlags.Convex)
    vg.resetClip(ctx)
    vg.beginPath(ctx)
    vg.moveTo(ctx, 130.0, 90.0)
    for i in range(50):
        vg.lineTo(ctx, 132.0 + i * 1.5, 90.0 + (7.0 if i % 2 else -7.0))
    vg.lineTo(ctx, 130.0, 110.0)
    vg.closePath(ctx)
    vg.fillPath(ctx, vg.color4ub(220, 120, 30, 255), vg.FillFlags.ConcaveNonZeroAA)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (16, 16, 4), np.uint8)
    img[..., 3] = 255
    h_img = vg.createImage(ctx, 16, 16, 0, img)
    p = vg.createImagePattern(ctx, 200, 96, 32, 32, 0.0, h_img)
    vg.beginPath(ctx)
    vg.rect(ctx, 196, 92, 50, 30)
    vg.fillPath(ctx, p, vg.Colors.White, vg.FillFlags.ConvexAA)
    if font_data is not None:
        f = vg.createFont(ctx, "sans", font_data, len(font_data), 0)
        cfg = vg.makeTextConfig(ctx, f, 18.0, vg.TextAlign.BaselineLeft,
                                vg.Colors.White)
        vg.text(ctx, cfg, 130, 24, "ss frame")


def _clip_everything(ctx, vg, font_data):
    """Every tile holds clip commands, so no chunk is resolvable and the
    split returns None: every bucket takes form (d)."""
    vg.beginClip(ctx, vg.ClipRule.In)
    vg.beginPath(ctx)
    vg.rect(ctx, 0, 0, 256, 128)
    vg.fillPath(ctx, vg.Colors.Black, vg.FillFlags.Convex)
    vg.endClip(ctx)
    _ss_scene(ctx, vg, font_data)
    vg.resetClip(ctx)


def _end_both(draw, ss, w=256, h=128, **cfg):
    """The scene through vgtpu's end() and the port's on the CPU, both
    with ContextConfig(coverage_supersample=ss, **cfg)."""
    ctx_j = vgj.createContext(vgj.ContextConfig(device_sampling=False,
                                                coverage_supersample=ss, **cfg))
    vgj.begin(ctx_j, 0, w, h, 1.0)
    draw(ctx_j, vgj, FONT_DATA)
    ref = np.asarray(vgj.end(ctx_j, background=BG))
    ctx = vgt.createContext(vgt.ContextConfig(coverage_supersample=ss, **cfg),
                            device="cpu")
    vgt.begin(ctx, 0, w, h, 1.0)
    draw(ctx, vgt, FONT_DATA)
    img = vgt.end(ctx, background=BG)
    assert img.shape == (h, w, 4) and img.device.type == "cpu"
    np.testing.assert_allclose(img.numpy(), ref, atol=1e-5, rtol=0)
    u8 = image_to_u8(img).astype(np.int16)
    assert np.abs(u8 - image_to_u8_j(ref).astype(np.int16)).max() <= 1
    return ctx


@pytest.mark.parametrize("ss", [2, 4])
def test_end_matches_vgtpu_supersampled(ss):
    """vgtpu renders its XLA composite on the CPU; the port splits the
    pools and runs K3's and K2's twins (forms (d) and (e))."""
    ctx = _end_both(_ss_scene, ss)
    rh = ctx.last_plan.resolve_host
    assert rh["nres"] > 0 and rh["nraw"] > 0
    d = ctx.last_device_arrays
    assert d["res"] is not None
    flags = d["bucket_flags"]
    assert any(f[3] for f in flags) and not all(f[3] for f in flags)
    assert any(f[2] for f in flags), "no textured bucket"
    assert any(r is not None and bool(r.any()) for r in d["bucket_rbd"])
    assert ctx.last_plan.color_tiles.shape[1] == ctx.cfg.tile_h


def test_end_supersampled_without_split():
    ctx = _end_both(_clip_everything, 2)
    assert ctx.last_plan.resolve_host == {}
    d = ctx.last_device_arrays
    assert d["res"] is None and all(f[3] for f in d["bucket_flags"])


def test_end_supersampled_ss8():
    """ss=8: 64 sub-rows per tile, within K3's and K2's limits."""
    ctx = _end_both(_ss_scene, 8, w=128, h=64)
    assert ctx.last_plan.tile_h == 64


@pytest.mark.parametrize("cfg,ss,w,h", [
    ({"tile_w": 256}, 1, 256, 128),
    ({"tile_w": 256}, 2, 256, 128),
    ({"tile_h": 16}, 1, 256, 128),
    ({"tile_h": 16}, 2, 256, 128),
    ({"tile_h": 16}, 8, 128, 64),
], ids=["tile_w256-ss1", "tile_w256-ss2", "tile_h16-ss1", "tile_h16-ss2",
        "tile_h16-ss8"])
def test_end_matches_vgtpu_tile_shapes(cfg, ss, w, h):
    """Tile shapes beyond 8x128 that vgtpu admits: 256-wide tiles, and
    16-row tiles up to 128 sub-rows at ss=8.  The port's kernels take them
    on the card (K2 loops over pixel groups, K3 sizes its rparams staging
    at launch: ops/composite_cuda.k2_geometry, ops/coverage_resolve_cuda.
    k3_geometry); here the twins of the same path are held to vgtpu."""
    ctx = _end_both(_ss_scene, ss, w=w, h=h, **cfg)
    plan = ctx.last_plan
    assert plan.tile_w == cfg.get("tile_w", 128)
    assert plan.tile_h == cfg.get("tile_h", 8) * ss
    d = ctx.last_device_arrays
    assert (d["res"] is not None) == (ss > 1)
    assert d["bucket_flags"]


def _deep_chunks(ctx, vg, font_data):
    from vgtpu_torch.scenes.small import draw_deep_chunk_scene

    draw_deep_chunk_scene(ctx, font_data, vg=vg)


@pytest.mark.parametrize("ss", [1, 2])
def test_end_matches_vgtpu_chunk_pools_over_32_edges(ss):
    """ContextConfig(chunk_pools=(2, 8, 48)): the native binner fills
    48-edge chunks (over the 32 that K1, K3 and K4 once staged) at ss=1 and
    in the parity mode, whose split puts such chunks in a RES pool (K3) and
    a RAW pool (K1).  The twins of the path are held to vgtpu."""
    ctx = _end_both(_deep_chunks, ss, w=WIDTH, h=HEIGHT, chunk_pools=(2, 8, 48))
    d = ctx.last_device_arrays
    k = len(d["res"]["rparams"]) if ss > 1 else 0
    assert (d["res"] is not None) == (ss > 1)

    def live48(pools):
        return sum(int((ce.abs().sum(dim=(1, 2)) > 0).sum())
                   for ce in pools if int(ce.shape[1]) == 48)

    if ss == 1:
        assert live48(d["chunk_edges"]) >= 3
    else:
        assert live48(d["chunk_edges"][:k]) >= 1     # RES: K3
        assert live48(d["chunk_edges"][k:]) >= 2     # RAW: K1


def _deep_tile(ctx, vg, font_data):
    from vgtpu_torch.scenes.small import draw_deep_tile_scene

    draw_deep_tile_scene(ctx, font_data, vg=vg)


@pytest.mark.parametrize("ss", [1, 2])
def test_end_matches_vgtpu_chunks_deeper_than_the_shallow_staging(ss):
    """ContextConfig(chunk_pools=(2, 8, 2048)) on a scene that puts 2,000
    edges of one path into one tile: the binner and the host path take the
    pool, its chunk is deeper than the 1,808 edges a shallow K1 block
    staged, and K1 (and at ss=2 K3, which the chunk's entry reaches) take
    their deep forms for the launch (ops/coverage_cuda.k1_geometry,
    ops/coverage_resolve_cuda.k3_geometry).  The twins of the path are
    held to vgtpu."""
    from vgtpu_torch.ops.coverage_cuda import k1_geometry
    from vgtpu_torch.ops.coverage_resolve_cuda import k3_geometry

    ctx = _end_both(_deep_tile, ss, w=WIDTH, h=HEIGHT, chunk_pools=(2, 8, 2048))
    d = ctx.last_device_arrays
    k = len(d["res"]["rparams"]) if ss > 1 else 0
    th = ctx.last_plan.tile_h

    def deepest(pools):
        return max(int((ce.abs().sum(dim=2) > 0).sum(dim=1).max()) for ce in pools)

    assert max(int(ce.shape[1]) for ce in d["chunk_edges"]) == 2048
    assert deepest(d["chunk_edges"]) > 1_809
    assert k1_geometry(th, 128, 2048)["form"] == "deep"
    if ss > 1:
        assert deepest(d["chunk_edges"][:k]) > 1_809          # a RES chunk: K3
        assert k3_geometry(th, ss, 2048)["form"] == "deep"


def _rounded_rect(ctx, vg, _font_data):
    vg.beginPath(ctx)
    vg.roundedRect(ctx, 10, 10, 150, 90, 18)
    vg.fillPath(ctx, vg.color4ub(200, 80, 40, 255), vg.FillFlags.ConvexAA)


def test_end_supersampled_without_a_pad_entry():
    """A plan whose entry table has no pad row (n_real_entries == NE): the
    split's pad RES chunks must not become the primary chunk of the last,
    real entry."""
    ctx = _end_both(_rounded_rect, 2, w=320, h=160)
    plan = ctx.last_plan
    assert plan.n_real_entries == plan.entry_backdrop.shape[0]
    assert ctx.last_device_arrays["res"] is not None
