"""The port end to end on the CPU: vg.end() of vgtpu_torch against vgtpu's on
the same scene, the package importing with jax blocked, and the entry
points that must refuse (no CUDA, unported features).

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
from vgtpu_torch.raster.retained import RetainedScene  # noqa: E402
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
    """end() takes the full path every frame; execute_plan and the plain
    execute_plan_torch are the same computation on the CPU."""
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


@pytest.mark.parametrize("call", [
    lambda ctx: vgt.end(ctx, dispatch=False),
    lambda ctx: vgt.renderFrames([ctx]),
    lambda ctx: vgt.createCommandList(ctx, 0),
    lambda ctx: vgt.clBeginPath(ctx, None),
    lambda ctx: vgt.VariantBatch.bake(ctx, [], 64, 64),
    lambda ctx: RetainedScene.bake(ctx),
], ids=["end_no_dispatch", "renderFrames", "createCommandList", "clBeginPath",
        "VariantBatch", "RetainedScene"])
def test_unported_entry_points_raise(call):
    ctx = vgt.createContext(device="cpu")
    vgt.begin(ctx, 0, 64, 64, 1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        call(ctx)


def test_supersampled_frames_raise():
    ctx = vgt.createContext(vgt.ContextConfig(coverage_supersample=2), device="cpu")
    vgt.begin(ctx, 0, 128, 64, 1.0)
    vgt.beginPath(ctx)
    vgt.circle(ctx, 30, 30, 20)
    vgt.fillPath(ctx, vgt.Colors.Red, vgt.FillFlags.ConvexAA)
    with pytest.raises(NotImplementedError, match="ss>1"):
        vgt.end(ctx)
