"""The port's fused painter composite (vgtpu_torch/ops/composite.py) against
vgtpu's Pallas composite in interpret mode: one bucket at a time on
identical inputs (the plain twin of kernel K2), and the whole fused frame
(frame_fb vs frame_fb_pallas), on a scene that turns on every lane —
gradient, triangle colours, textures (text + image pattern), clip, even-odd,
non-AA, scissor.  Recipe of tests/test_composite_pallas.py::
test_frame_fb_pallas_fused_parity, atol=2e-6: the same float32 expressions
in the same order; XLA's FMA contractions move a few ulps of values <= 1."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's thread pool oversubscribed them by orders of magnitude
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import vgtpu as vgj  # noqa: E402
from vgtpu.ops.composite_pallas import composite_bucket_pallas, frame_fb_pallas  # noqa: E402
from vgtpu_torch.ops.composite import (  # noqa: E402
    build_bucket_aux,
    composite_bucket_torch,
    frame_fb,
)
from vgtpu_torch.raster.binning import plan_from_numpy  # noqa: E402
from vgtpu_torch.raster.frame import plan_host_arrays  # noqa: E402
from vgtpu_torch.scenes.small import draw_feature_scene  # noqa: E402

W, H = 512, 256
BG = (0.1, 0.2, 0.3, 1.0)


@pytest.fixture(scope="module")
def feature_plan():
    """The scene recorded and binned by vgtpu, handed to the port as numpy
    fields (plan_from_numpy), with the port's fused host arrays."""
    from tests.fontdata import FONT_DATA
    from vgtpu.raster.binning import bin_frame

    if FONT_DATA is None:
        pytest.skip("no test font: the texture lane needs text")
    ctx = vgj.createContext(vgj.ContextConfig(device_sampling=False))
    vgj.begin(ctx, 0, W, H, 1.0)
    draw_feature_scene(ctx, FONT_DATA, vg=vgj)
    ctx._finalize_ops()
    plan_j = bin_frame(ctx.ops, W, H)
    ctx._fill_textures(plan_j)
    plan = plan_from_numpy(dataclasses.asdict(plan_j))
    host = plan_host_arrays(plan)
    flags = np.array(host["bucket_flags"])
    assert flags.any(axis=0).all(), f"scene misses a lane: {flags.any(axis=0)}"
    return plan, host


def _cov_all(plan, host):
    from vgtpu_torch.ops.coverage import cov_all_resolved

    return cov_all_resolved(
        [torch.from_numpy(ce) for ce in host["chunk_edges"]],
        {k: torch.from_numpy(v) for k, v in host["cov_map"].items()},
        plan.tile_h, plan.tile_w).numpy()


@pytest.mark.parametrize("all_lanes", [False, True])
def test_composite_bucket_torch_matches_pallas(feature_plan, all_lanes):
    """Every bucket with its own lane flags, and with all seven forced on
    (a lane on for a bucket that has no such entry must change nothing)."""
    plan, host = feature_plan
    cov = _cov_all(plan, host)
    npx = plan.tile_h * plan.tile_w
    bg_vec = np.repeat(np.asarray(BG, np.float32), npx)[:, None]
    for (te_b, _ids, _fl), pteb, flags in zip(
            plan.tile_buckets, host["bucket_pteb"], host["bucket_flags"]):
        flags = (True,) * 7 if all_lanes else flags
        pp, ct_t = build_bucket_aux(plan, te_b, need_ct=flags[2])
        ew_t = np.ascontiguousarray(cov[pteb].transpose(1, 2, 0))
        ref = np.asarray(composite_bucket_pallas(
            jnp.asarray(ew_t), jnp.asarray(pp),
            None if ct_t is None else jnp.asarray(ct_t), jnp.asarray(bg_vec),
            npx=npx, tile_w=plan.tile_w, flags=flags, add_backdrop=True,
            interpret=True))
        got = composite_bucket_torch(
            torch.from_numpy(ew_t), torch.from_numpy(pp),
            None if ct_t is None else torch.from_numpy(ct_t),
            torch.from_numpy(bg_vec), tile_w=plan.tile_w, flags=flags)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=0)


def test_frame_fb_matches_frame_fb_pallas(feature_plan):
    plan, host = feature_plan
    cov = _cov_all(plan, host)
    nt = plan.ntx * plan.nty
    params, cts = [], []
    for te_b, _ids, flags in plan.tile_buckets:
        pp, ct = build_bucket_aux(plan, te_b, need_ct=bool(flags[2]))
        params.append(jnp.asarray(pp))
        cts.append(None if ct is None else jnp.asarray(ct))
    ref = np.asarray(frame_fb_pallas(
        jnp.asarray(cov),
        [(jnp.asarray(te), jnp.asarray(ids)) for te, ids, _fl in plan.tile_buckets],
        tuple(jnp.asarray(p) for p in host["bucket_pteb"]), tuple(params),
        tuple(cts), jnp.asarray(np.asarray(BG, np.float32)),
        tile_h=plan.tile_h, tile_w=plan.tile_w, num_tiles=nt,
        bucket_flags=host["bucket_flags"], interpret=True))

    def t(x):
        return None if x is None else torch.from_numpy(x)

    got = frame_fb(
        torch.from_numpy(cov), [t(x) for x in host["bucket_ids"]],
        [t(x) for x in host["bucket_pteb"]],
        [t(x) for x in host["bucket_params"]],
        [t(x) for x in host["bucket_ctile"]], t(host["ct_flat"]), BG,
        tile_h=plan.tile_h, tile_w=plan.tile_w, num_tiles=nt,
        bucket_flags=host["bucket_flags"])
    assert got.shape == ref.shape == (nt, plan.tile_h, plan.tile_w, 4)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=0)


def test_composite_bucket_rejects_other_devices():
    from vgtpu_torch.ops.composite import composite_bucket

    fb = torch.zeros((2, 8, 128, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        composite_bucket(fb, fb, fb, fb, fb, None, fb, BG, tile_w=128,
                         flags=(False,) * 7)


def test_k2_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain twin: a CPU framebuffer raises
    before any build or launch."""
    from vgtpu_torch.ops.composite_cuda import K2, composite_bucket_cuda

    fb = torch.zeros((2, 8, 128, 4))
    before = K2.launches
    with pytest.raises(ValueError, match="framebuffer on cpu"):
        composite_bucket_cuda(fb, fb, fb, fb, fb, None, fb, BG, tile_w=128,
                              flags=(False,) * 7)
    assert K2.launches == before
