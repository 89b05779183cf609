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
from vgtpu_torch.scenes.small import (  # noqa: E402
    draw_feature_scene,
    draw_resolve_scene,
)

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


@pytest.mark.parametrize("ss", [1, 2, 4, 8])
@pytest.mark.parametrize("tile_h", [8, 16, 24, 32])
@pytest.mark.parametrize("tile_w", [128, 256])
def test_k2_geometry_admits_every_tile_shape(tile_w, tile_h, ss):
    """K2's launch geometry for every tile shape vgtpu admits (tile_w 128 or
    256, tile_h a multiple of 8, ss 1/2/4/8), every form and lane set that
    sizes its shared memory, and buckets of 1 to 256 slots (the depth cap):
    admitted, within the 227 KB a block may use, the pixel groups covering
    the tile exactly once, the slot windows covering every slot."""
    from vgtpu_torch.ops.composite_cuda import (
        PIX, SMEM_LIMIT, STAGES, WINDOW, k2_geometry)

    npx_out = tile_h * tile_w
    for final, clip, tex in [(False, False, False), (False, True, False),
                             (False, False, True), (False, True, True),
                             (True, False, False), (True, False, True)]:
        for mo in (1, 31, 64, 65, 256):
            g = k2_geometry(tile_h, tile_w, ss, mo=mo, final=final, clip=clip,
                            tex=tex)
            assert g["smem_bytes"] <= SMEM_LIMIT == 232_448
            group = g["threads"] * PIX
            assert g["threads"] in (128, 256) and group % tile_w in (0, group)
            assert (g["groups"] - 1) * group < npx_out <= g["groups"] * group
            assert g["group_rows"] == min(tile_h, max(1, group // tile_w))
            assert (g["windows"] - 1) * WINDOW < mo <= g["windows"] * WINDOW
            # the ring and clip pieces are the larger part: ss per thread
            # and stage (one in form (e)), 4 colour planes, 2*ss clip
            chunks = 1 if final else ss
            ring = 16 * g["threads"] * STAGES * (chunks + 4 * tex)
            assert ring + 16 * g["threads"] * 2 * ss * clip < g["smem_bytes"]


def test_k2_geometry_refusals():
    """Shapes K2 cannot take raise ValueError naming the limit."""
    from vgtpu_torch.ops.composite_cuda import k2_geometry

    # the 1080p frame's ss=1 buckets without texture: csrc/composite.cu's note
    assert k2_geometry(8, 128, 1)["smem_bytes"] == 22_800
    with pytest.raises(ValueError, match="multiple of 4"):
        k2_geometry(8, 130, 1)
    with pytest.raises(ValueError, match="clip lane"):
        k2_geometry(8, 128, 2, final=True, clip=True)
    with pytest.raises(ValueError, match="over the card's 232448"):
        k2_geometry(8, 128, 64, clip=True, tex=True)


def test_background_tensor_is_uploaded_once():
    """frame_fb's background lives on the device once per (device,
    background): the same tensor for the same floats, a new one for new
    floats, and a bounded cache."""
    from vgtpu_torch.ops import composite

    a = composite.background_tensor((0.1, 0.2, 0.3, 1.0), "cpu")
    assert a is composite.background_tensor([0.1, 0.2, 0.3, 1], torch.device("cpu"))
    assert torch.equal(a, torch.tensor((0.1, 0.2, 0.3, 1.0)))
    for k in range(2 * composite._BACKGROUNDS_MAX):
        composite.background_tensor((k, 0, 0, 1), "cpu")
    assert len(composite._BACKGROUNDS) <= composite._BACKGROUNDS_MAX
    assert composite.background_tensor((0.1, 0.2, 0.3, 1.0), "cpu") is not a


_SS_FIELDS = {}


def _ss_plan(ss):
    """(vgtpu plan, port plan) of draw_resolve_scene at ss, both unsplit and
    each a fresh copy: vgtpu records and bins once per ss, both packages get
    the numpy fields."""
    import copy

    from vgtpu.raster.binning import FramePlan as FramePlanJ

    if ss not in _SS_FIELDS:
        from tests.fontdata import FONT_DATA
        from vgtpu.raster.binning import bin_frame

        if FONT_DATA is None:
            pytest.skip("no test font: the texture lane needs text")
        ctx = vgj.createContext(vgj.ContextConfig(device_sampling=False))
        vgj.begin(ctx, 0, W, H, 1.0)
        draw_resolve_scene(ctx, FONT_DATA, vg=vgj)
        ctx._finalize_ops()
        plan_j = bin_frame(ctx.ops, W, H, supersample=ss)
        ctx._fill_textures(plan_j)
        _SS_FIELDS[ss] = dataclasses.asdict(plan_j)
    fields = _SS_FIELDS[ss]
    return FramePlanJ(**copy.deepcopy(fields)), plan_from_numpy(fields)


def _pallas_bucket(ew_t, pp, ct_t, npx_out, plan, flags, ss, **kw):
    bg_vec = np.repeat(np.asarray(BG, np.float32), npx_out)[:, None]
    return np.asarray(composite_bucket_pallas(
        jnp.asarray(ew_t), jnp.asarray(pp),
        None if ct_t is None else jnp.asarray(ct_t), jnp.asarray(bg_vec),
        npx=plan.tile_h * plan.tile_w, tile_w=plan.tile_w, flags=flags,
        interpret=True, ss=ss, **kw))


def _twin_bucket(ew_t, pp, ct_t, npx_out, plan, flags, ss, **kw):
    bg_vec = np.repeat(np.asarray(BG, np.float32), npx_out)[:, None]
    return composite_bucket_torch(
        torch.from_numpy(ew_t), torch.from_numpy(pp),
        None if ct_t is None else torch.from_numpy(ct_t),
        torch.from_numpy(bg_vec), tile_w=plan.tile_w, flags=flags, ss=ss,
        **kw).numpy()


@pytest.mark.parametrize("ss", [2, 4])
def test_composite_bucket_torch_sub_rows_matches_pallas(ss):
    """Form (d): raw sub-row coverage with the backdrop added, rule, AA,
    scissor and clip per sub-row, ss-averaged; every bucket of the unsplit
    plan, clip buckets included."""
    from vgtpu_torch.ops.coverage import build_cov_gather_map
    from vgtpu_torch.ops.composite import build_bucket_pteb
    from vgtpu_torch.raster.binning import compute_tile_buckets
    from vgtpu_torch.raster.frame import _compact_culled_chunks

    _plan_j, plan = _ss_plan(ss)
    plan.tile_buckets = compute_tile_buckets(
        plan.tile_entries, plan.tile_entries.shape[0], plan.entry_kind, plan)
    _compact_culled_chunks(plan)
    m = build_cov_gather_map(plan.chunk_pools, plan.entry_backdrop.shape[0])
    dead = int(sum(len(c) for _e, c in plan.chunk_pools))
    from vgtpu_torch.ops.coverage import cov_all_resolved

    cov = cov_all_resolved(
        [torch.from_numpy(np.ascontiguousarray(ce)) for ce, _c in plan.chunk_pools],
        {"extra_chunk": torch.from_numpy(m["extra_chunk"]),
         "extra_primary": torch.from_numpy(m["extra_primary"])},
        plan.tile_h, plan.tile_w).numpy()
    npx_out = plan.tile_h // ss * plan.tile_w
    seen = np.zeros(7, bool)
    for te_b, _ids, flags in plan.tile_buckets:
        flags = tuple(bool(f) for f in flags)
        seen |= flags
        pp, ct_t = build_bucket_aux(plan, te_b, need_ct=flags[2])
        pteb = build_bucket_pteb(te_b, m["primary"], dead)
        ew_t = np.ascontiguousarray(cov[pteb].transpose(1, 2, 0))
        ref = _pallas_bucket(ew_t, pp, ct_t, npx_out, plan, flags, ss,
                             add_backdrop=True)
        got = _twin_bucket(ew_t, pp, ct_t, npx_out, plan, flags, ss)
        assert got.shape == ref.shape == (4 * npx_out, pteb.shape[0])
        np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)
    assert seen.all(), f"scene misses a lane: {seen}"


def _split_cov(plan, host):
    from vgtpu_torch.ops.coverage_resolve import cov_split_resolved

    from vgtpu_torch.raster.frame import _put

    return cov_split_resolved(_put(host["chunk_edges"], "cpu"),
                              _put(host["res"], "cpu"), plan.tile_h,
                              plan.tile_w, plan.supersample)


def test_composite_bucket_torch_final_matches_pallas():
    """Form (e): final coverage of the resolve split with resolved-backdrop
    rows, every non-clip bucket, the scissor lane and non-zero rbd among
    them."""
    ss = 2
    _plan_j, plan = _ss_plan(ss)
    host = plan_host_arrays(plan)
    assert host["res"] is not None
    cov_final = _split_cov(plan, host)[0].numpy()
    npx_out = plan.tile_h // ss * plan.tile_w
    scissor_rbd = False
    for (te_b, _ids, _fl), pteb, pp, rbd, flags in zip(
            plan.tile_buckets, host["bucket_pteb"], host["bucket_params"],
            host["bucket_rbd"], host["bucket_flags"]):
        if flags[3]:
            continue
        scissor_rbd |= bool(flags[6] and rbd.any())
        _pp, ct_t = build_bucket_aux(plan, te_b, need_ct=flags[2])
        ew_t = np.ascontiguousarray(cov_final[pteb].transpose(1, 2, 0))
        ref = _pallas_bucket(ew_t, pp, ct_t, npx_out, plan, flags, ss,
                             cov_final=True, rbd_t=jnp.asarray(rbd))
        got = _twin_bucket(ew_t, pp, ct_t, npx_out, plan, flags, ss,
                           cov_final=True, rbd_t=torch.from_numpy(rbd))
        np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)
    assert scissor_rbd, "no scissored bucket with resolved-backdrop rows"


def test_frame_fb_split_matches_frame_fb_pallas():
    """The whole supersampled fused frame: cov_split_resolved + frame_fb
    (forms (d) and (e)) against vgtpu's frame_fb_pallas on its own split,
    the bound of tests/test_resolve_path.py."""
    from vgtpu.ops.coverage_resolve import cov_split_resolved as split_j
    from vgtpu.raster import frame as frame_j

    ss = 2
    plan_j, plan = _ss_plan(ss)
    mp = pytest.MonkeyPatch()
    mp.setattr(frame_j, "_fused_platform", lambda: True)
    try:
        d = frame_j.plan_to_device(plan_j)
        frame_j.promote_resident(plan_j, d)
    finally:
        mp.undo()
    nt = plan.ntx * plan.nty
    fin_j, sub_j = split_j(d["chunk_pools"], d["res"], plan_j.tile_h,
                           plan_j.tile_w, ss)
    ref = np.asarray(frame_fb_pallas(
        sub_j, d["tile_buckets"], d["res"]["pteb"], d["bucket_params"],
        d["bucket_cts"], jnp.asarray(np.asarray(BG, np.float32)),
        tile_h=plan_j.tile_h, tile_w=plan_j.tile_w, num_tiles=nt,
        bucket_flags=d["bucket_flags"], interpret=True, ss=ss,
        cov_final_arr=fin_j, bucket_rbd=d["res"]["rbd"]))

    host = plan_host_arrays(plan)
    cov_final, cov_sub = _split_cov(plan, host)

    def t(x):
        return None if x is None else torch.from_numpy(x)

    got = frame_fb(
        cov_sub, [t(x) for x in host["bucket_ids"]],
        [t(x) for x in host["bucket_pteb"]],
        [t(x) for x in host["bucket_params"]],
        [t(x) for x in host["bucket_ctile"]], t(host["ct_flat"]), BG,
        tile_h=plan.tile_h, tile_w=plan.tile_w, num_tiles=nt,
        bucket_flags=host["bucket_flags"], ss=ss, cov_final_arr=cov_final,
        bucket_rbd=[t(x) for x in host["bucket_rbd"]])
    assert got.shape == ref.shape == (nt, plan.tile_h // ss, plan.tile_w, 4)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-6, rtol=0)



# ---- K2 forms (b) per-tile init planes and (c) k_rep variant blocks -------

_FLAGS_BC = (True, False, False, False, True, True, True)   # grad, eo, noaa, scissor


def _synthetic_bucket(rng, *, ss, k_rep=1, nb=128, mo=4, th_out=8, tw=16):
    """A bucket of nb tiles (8x16 output pixels) x mo slots with random solid
    and gradient paints, rules, AA, scissors and backdrops; k_rep variant
    blocks of params that differ in their colours.  Returns (ew_t raw
    sub-row winding (MO, NPX, nb), params (MO, NPP, k_rep*nb), th)."""
    from vgtpu_torch.ops.composite import (
        _P_AA, _P_BD, _P_KIND, _P_OX, _P_OY, _P_PAINT, _P_PK, _P_RULE, _P_SC,
        _P_VALID, _npp)
    from vgtpu_torch.raster.binning import K_DRAW, P_GRADIENT, P_SOLID

    th = th_out * ss
    pp = np.zeros((mo, _npp(th), nb), np.float32)
    valid = rng.uniform(size=(mo, nb)) < 0.85
    pp[:, _P_VALID] = valid
    pp[:, _P_KIND] = K_DRAW
    pp[:, _P_RULE] = rng.integers(0, 2, (mo, nb))
    pp[:, _P_AA] = rng.integers(0, 2, (mo, nb))
    pp[:, _P_PK] = np.where(rng.uniform(size=(mo, nb)) < 0.5, P_SOLID, P_GRADIENT)
    tile = np.arange(nb)
    ox, oy = (tile % 16) * tw, (tile // 16) * th
    pp[:, _P_OX], pp[:, _P_OY] = ox, oy
    has = rng.uniform(size=(mo, nb)) < 0.5
    x0, y0 = ox + rng.uniform(-4, tw, (mo, nb)), oy + rng.uniform(-4, th, (mo, nb))
    pp[:, _P_SC + 0] = np.where(has, x0, -1e9)
    pp[:, _P_SC + 1] = np.where(has, y0, -1e9)
    pp[:, _P_SC + 2] = np.where(has, x0 + rng.uniform(1, tw, (mo, nb)), 1e9)
    pp[:, _P_SC + 3] = np.where(has, y0 + rng.uniform(1, th, (mo, nb)), 1e9)
    paint = np.zeros((18, mo, nb), np.float32)
    paint[0:4] = rng.uniform(-0.1, 0.1, (4, mo, nb)) + np.array([1, 0, 0, 1])[:, None, None]
    paint[4:6] = rng.uniform(-300, 0, (2, mo, nb))
    paint[6:8] = rng.uniform(5, 60, (2, mo, nb))
    paint[8] = rng.uniform(0, 5, (mo, nb))
    paint[9] = rng.uniform(1, 20, (mo, nb))
    paint[10:18] = rng.uniform(0, 1, (8, mo, nb))
    pp[:, _P_PAINT : _P_PAINT + 18] = paint.transpose(1, 0, 2)
    pp[:, _P_BD : _P_BD + th] = (rng.integers(-1, 2, (mo, th, nb))
                                 * valid[:, None, :])
    blocks = [pp]
    for _k in range(1, k_rep):
        q = pp.copy()
        q[:, _P_PAINT + 10 : _P_PAINT + 18] = rng.uniform(0, 1, (mo, 8, nb))
        blocks.append(q)
    ew_t = rng.uniform(-1.2, 1.2, (mo, th * tw, nb)).astype(np.float32)
    return ew_t, np.ascontiguousarray(np.concatenate(blocks, axis=2)), th


def _both_bucket(ew_t, pp, bg_vec, th, ss, k_rep=1, tw=16):
    ref = np.asarray(composite_bucket_pallas(
        jnp.asarray(ew_t), jnp.asarray(pp), None, jnp.asarray(bg_vec),
        npx=th * tw, tile_w=tw, flags=_FLAGS_BC, add_backdrop=True,
        interpret=True, ss=ss, k_rep=k_rep))
    got = composite_bucket_torch(
        torch.from_numpy(ew_t), torch.from_numpy(pp), None,
        torch.from_numpy(bg_vec), tile_w=tw, flags=_FLAGS_BC, ss=ss,
        k_rep=k_rep).numpy()
    return got, ref


@pytest.mark.parametrize("ss", [1, 2])
def test_composite_bucket_torch_init_plane_matches_pallas(ss):
    """Form (b): a random per-tile init plane (4*NPX_OUT, Nb) instead of
    the broadcast background column (vgtpu's layer-memo bg_vec)."""
    rng = np.random.default_rng(11 + ss)
    ew_t, pp, th = _synthetic_bucket(rng, ss=ss)
    plane = rng.uniform(0, 1, (4 * 8 * 16, pp.shape[2])).astype(np.float32)
    got, ref = _both_bucket(ew_t, pp, plane, th, ss)
    assert got.shape == ref.shape == plane.shape
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)
    # the plane is what the tiles start from: a different plane moves them
    other, _ = _both_bucket(ew_t, pp, plane * 0.5, th, ss)
    assert not np.allclose(other, got)


@pytest.mark.parametrize("ss", [1, 2])
def test_composite_bucket_torch_k_rep_matches_pallas(ss):
    """Form (c): k_rep=2 variant blocks of params share one block of
    coverage (Pallas's ew index map i % bpv); Nb = 128, 8x16 tiles, MO 4."""
    rng = np.random.default_rng(21 + ss)
    ew_t, pp, th = _synthetic_bucket(rng, ss=ss, k_rep=2)
    bg_vec = np.repeat(np.asarray(BG, np.float32), 8 * 16)[:, None]
    got, ref = _both_bucket(ew_t, pp, bg_vec, th, ss, k_rep=2)
    assert got.shape == ref.shape == (4 * 8 * 16, 256)
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)
    # each variant block equals its own k_rep=1 render
    for k in range(2):
        one, _ = _both_bucket(ew_t, np.ascontiguousarray(pp[:, :, 128 * k : 128 * (k + 1)]),
                              bg_vec, th, ss)
        np.testing.assert_array_equal(got[:, 128 * k : 128 * (k + 1)], one)


def test_frame_fb_init_tiles_matches_frame_fb_pallas(feature_plan):
    """The whole fused frame over resident init tiles (the layer memo): the
    framebuffer starts as the tiles plus the background scratch row and
    every bucket takes form (b); tiles no bucket covers keep their init."""
    plan, host = feature_plan
    cov = _cov_all(plan, host)
    nt = plan.ntx * plan.nty
    init = np.random.default_rng(7).uniform(
        0, 1, (nt, plan.tile_h, plan.tile_w, 4)).astype(np.float32)
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
        bucket_flags=host["bucket_flags"], interpret=True,
        init_tiles=jnp.asarray(init)))

    def t(x):
        return None if x is None else torch.from_numpy(x)

    got = frame_fb(
        torch.from_numpy(cov), [t(x) for x in host["bucket_ids"]],
        [t(x) for x in host["bucket_pteb"]],
        [t(x) for x in host["bucket_params"]],
        [t(x) for x in host["bucket_ctile"]], t(host["ct_flat"]), BG,
        tile_h=plan.tile_h, tile_w=plan.tile_w, num_tiles=nt,
        bucket_flags=host["bucket_flags"], init_tiles=torch.from_numpy(init))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=0)
    covered = np.zeros(nt, bool)
    for ids in host["bucket_ids"]:
        covered[ids[ids < nt]] = True
    assert (~covered).any(), "every tile is covered: init never shows"
    np.testing.assert_array_equal(got.numpy()[~covered], init[~covered])


def test_k2_twin_refuses_bad_k_rep():
    """k_rep needs ids for k_rep blocks of the coverage rows' tiles, and
    raw sub-row coverage (vgtpu's batch never pairs it with cov_final)."""
    from vgtpu_torch.ops.composite import composite_bucket_into_torch

    fb = torch.zeros((3, 8, 128, 4))
    pteb = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="coverage rows"):
        composite_bucket_into_torch(fb, torch.zeros((2, 1024)), pteb, None, None,
                                    None, torch.zeros(3, dtype=torch.int32), BG,
                                    tile_w=128, flags=(False,) * 7, k_rep=2)
    with pytest.raises(ValueError, match="k_rep=1"):
        composite_bucket_torch(torch.zeros((4, 1024, 1)), torch.zeros((4, 48, 2)),
                               None, torch.zeros((4096, 1)), tile_w=128,
                               flags=(False,) * 7, ss=1, cov_final=True,
                               rbd_t=torch.zeros((4, 8, 1)), k_rep=2)


# ---- the oracle composite of the sharded paths -------------------------------

@pytest.mark.parametrize("ss,init", [(1, False), (2, False), (1, True)],
                         ids=["ss1", "ss2", "ss1-init_tiles"])
def test_composite_bucketed_body_matches_vgtpu(ss, init):
    """composite_bucketed_body (the plain torch oracle composite that the
    sharded frame and render_sharded run) against vgtpu's XLA body over a
    whole frame's buckets, from the same entry winding (the port's
    entry_coverage_from_pools + backdrop) of the resolve scene; once from
    random init tiles.  Measured max |diff| 4.8e-7 in each case (a few ulps
    of XLA's contractions in the shading): atol 1e-6."""
    from vgtpu.ops.composite import composite_bucketed_body as bucketed_j
    from vgtpu_torch.ops.composite import composite_bucketed_body
    from vgtpu_torch.ops.coverage import entry_coverage_from_pools
    from vgtpu_torch.raster.frame import _prepare_plan

    _plan_j, plan = _ss_plan(ss)
    _prepare_plan(plan)
    th, tw = plan.tile_h, plan.tile_w
    ne, nt = plan.entry_backdrop.shape[0], plan.ntx * plan.nty
    ew = entry_coverage_from_pools(
        [torch.from_numpy(ce) for ce, _ in plan.chunk_pools],
        [torch.from_numpy(c) for _, c in plan.chunk_pools], ne, th, tw)
    ew = (ew + torch.from_numpy(plan.entry_backdrop)[:, :, None]).numpy()
    flags = tuple(tuple(bool(f) for f in fl) for _te, _ids, fl in plan.tile_buckets)
    assert any(f[3] for f in flags) and any(f[2] for f in flags)
    init_tiles = (np.random.default_rng(3).uniform(0, 1, (nt, th // ss, tw, 4))
                  .astype(np.float32) if init else None)
    names = ("entry_kind", "entry_rule", "entry_aa", "entry_paint_kind",
             "entry_paint", "entry_scissor", "entry_color_tile", "color_tiles")
    kw = dict(ntx=plan.ntx, tile_h=th, tile_w=tw, num_tiles=nt,
              bucket_flags=flags, ss=ss)
    ref = np.asarray(bucketed_j(
        jnp.asarray(ew), [(jnp.asarray(te), jnp.asarray(ids))
                          for te, ids, _fl in plan.tile_buckets],
        *(jnp.asarray(getattr(plan, k)) for k in names),
        jnp.asarray(np.asarray(BG, np.float32)),
        init_tiles=None if init_tiles is None else jnp.asarray(init_tiles), **kw))
    got = composite_bucketed_body(
        torch.from_numpy(ew), [(torch.from_numpy(te), torch.from_numpy(ids))
                               for te, ids, _fl in plan.tile_buckets],
        *(torch.from_numpy(np.asarray(getattr(plan, k))) for k in names), BG,
        init_tiles=None if init_tiles is None else torch.from_numpy(init_tiles), **kw)
    assert got.shape == ref.shape == (nt, th // ss, tw, 4)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


# ---- K7: the flat composite over dense slot-major winding --------------------

def _entry_w(plan):
    """Entry winding with the backdrop, (NE, TH*TW): what vgtpu's
    composite_bucketed_pallas_body gathers by each bucket's entry table."""
    from vgtpu_torch.ops.coverage import entry_coverage_from_pools

    ne = plan.entry_backdrop.shape[0]
    ew = entry_coverage_from_pools(
        [torch.from_numpy(ce) for ce, _ in plan.chunk_pools],
        [torch.from_numpy(c) for _, c in plan.chunk_pools], ne, plan.tile_h,
        plan.tile_w)
    return (ew + torch.from_numpy(plan.entry_backdrop)[:, :, None]).reshape(ne, -1).numpy()


def test_pallas_flat_and_rows_kernels_agree(feature_plan):
    """vgtpu's flat (_kernel) and rows (_kernel_rows) composites give the
    same fb_t bit for bit at ss=1 on every bucket: the premise that lets
    composite_bucket_torch stand for K2 and K7 alike (the twin is held to
    the flat kernel without the backdrop rows below)."""
    plan, host = feature_plan
    cov = _cov_all(plan, host)
    npx = plan.tile_h * plan.tile_w
    bg_vec = jnp.asarray(np.repeat(np.asarray(BG, np.float32), npx)[:, None])
    for (te_b, _ids, _fl), pteb, flags in zip(
            plan.tile_buckets, host["bucket_pteb"], host["bucket_flags"]):
        pp, ct_t = build_bucket_aux(plan, te_b, need_ct=flags[2])
        args = (jnp.asarray(np.ascontiguousarray(cov[pteb].transpose(1, 2, 0))),
                jnp.asarray(pp), None if ct_t is None else jnp.asarray(ct_t), bg_vec)
        kw = dict(npx=npx, tile_w=plan.tile_w, flags=flags, add_backdrop=True,
                  interpret=True)
        flat = np.asarray(composite_bucket_pallas(*args, **kw, variant="flat"))
        np.testing.assert_array_equal(flat, composite_bucket_pallas(*args, **kw))


@pytest.mark.parametrize("add_backdrop", [True, False])
@pytest.mark.parametrize("all_lanes", [False, True])
def test_composite_bucket_flat_matches_pallas(feature_plan, all_lanes, add_backdrop):
    """composite_bucket_flat (K7's entry point) vs composite_bucket_pallas(
    variant="flat") on every bucket, with its own lanes and all seven forced
    on: over chunk coverage gathered by pteb with the backdrop rows added
    (add_backdrop), or over entry winding gathered by the bucket's entry
    table, backdrop included (vgtpu's composite_bucketed_pallas_body)."""
    from vgtpu_torch.ops.composite import composite_bucket_flat

    plan, host = feature_plan
    cov = _cov_all(plan, host) if add_backdrop else _entry_w(plan)
    npx = plan.tile_h * plan.tile_w
    bg_vec = np.repeat(np.asarray(BG, np.float32), npx)[:, None]
    for (te_b, _ids, _fl), pteb, te, flags in zip(
            plan.tile_buckets, host["bucket_pteb"], host["bucket_te"],
            host["bucket_flags"]):
        flags = (True,) * 7 if all_lanes else flags
        pp, ct_t = build_bucket_aux(plan, te_b, need_ct=flags[2])
        ew_t = np.ascontiguousarray(cov[pteb if add_backdrop else te].transpose(1, 2, 0))
        ref = np.asarray(composite_bucket_pallas(
            jnp.asarray(ew_t), jnp.asarray(pp),
            None if ct_t is None else jnp.asarray(ct_t), jnp.asarray(bg_vec),
            npx=npx, tile_w=plan.tile_w, flags=flags, add_backdrop=add_backdrop,
            interpret=True, variant="flat"))
        got = composite_bucket_flat(
            torch.from_numpy(ew_t), torch.from_numpy(pp),
            None if ct_t is None else torch.from_numpy(ct_t),
            torch.from_numpy(bg_vec), tile_w=plan.tile_w, flags=flags,
            add_backdrop=add_backdrop)
        assert got.shape == ref.shape == (4 * npx, pteb.shape[0])
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=0)


def _both_flat(ew_t, pp, bg_vec, k_rep=1, tw=16):
    from vgtpu_torch.ops.composite import composite_bucket_flat

    ref = np.asarray(composite_bucket_pallas(
        jnp.asarray(ew_t), jnp.asarray(pp), None, jnp.asarray(bg_vec),
        npx=ew_t.shape[1], tile_w=tw, flags=_FLAGS_BC, add_backdrop=True,
        interpret=True, variant="flat", k_rep=k_rep))
    got = composite_bucket_flat(
        torch.from_numpy(ew_t), torch.from_numpy(pp), None,
        torch.from_numpy(bg_vec), tile_w=tw, flags=_FLAGS_BC, add_backdrop=True,
        k_rep=k_rep).numpy()
    return got, ref


@pytest.mark.parametrize("k_rep", [1, 2])
def test_composite_bucket_flat_init_plane_and_k_rep_match_pallas(k_rep):
    """K7's entry point from a random per-tile init plane, and with k_rep=2
    variant blocks over one block of ew_t (Nb = 128, 8x16 tiles, MO 4), as
    the rows kernel's form (b) and (c) tests build them."""
    rng = np.random.default_rng(31 + k_rep)
    ew_t, pp, _th = _synthetic_bucket(rng, ss=1, k_rep=k_rep)
    plane = rng.uniform(0, 1, (4 * 8 * 16, pp.shape[2])).astype(np.float32)
    got, ref = _both_flat(ew_t, pp, plane, k_rep=k_rep)
    assert got.shape == ref.shape == plane.shape
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)


def test_composite_bucket_flat_refuses_k_rep_without_128_lanes():
    from vgtpu_torch.ops.composite import composite_bucket_flat

    with pytest.raises(ValueError, match="128-multiple lanes"):
        composite_bucket_flat(torch.zeros((4, 128, 96)), torch.zeros((4, 40, 192)),
                              None, torch.zeros((512, 1)), tile_w=16,
                              flags=(False,) * 7, k_rep=2)


def test_k7_wrapper_refuses_cpu_tensors_and_other_devices():
    """The CUDA wrapper never runs the plain twin: a CPU tensor raises
    before any build or launch; the dispatcher refuses devices other than
    CUDA and the CPU."""
    from vgtpu_torch.ops.composite import composite_bucket_flat
    from vgtpu_torch.ops.composite_flat_cuda import K7, composite_bucket_flat_cuda

    args = (torch.zeros((4, 128, 8)), torch.zeros((4, 40, 8)), None,
            torch.zeros((512, 1)))
    before = K7.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        composite_bucket_flat_cuda(*args, tile_w=16, flags=(False,) * 7)
    assert K7.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        composite_bucket_flat(*(a if a is None else a.to("meta") for a in args),
                              tile_w=16, flags=(False,) * 7)


@pytest.mark.parametrize("coverage", ["K5", "K6"])
def test_flat_frame_matches_vgtpu(feature_plan, coverage):
    """The slice as a whole: execute_plan_flat (chip_smoke.py's [5c] frame),
    assembled through coverage_chunks_t(variant="flat") (K5) or
    coverage_chunks (K6), the chunk->entry index_add_, the backdrop, and
    composite_bucket_flat (K7) per bucket, against vgtpu's
    composite_bucketed_pallas_body over its own
    entry_coverage_from_pools."""
    from vgtpu.ops.composite_pallas import composite_bucketed_pallas_body
    from vgtpu.ops.coverage import entry_coverage_from_pools as entry_cov_j
    from vgtpu_torch.raster.frame import _put, execute_plan_flat

    plan, host = feature_plan
    th, tw = plan.tile_h, plan.tile_w
    ne, nt = plan.entry_backdrop.shape[0], plan.ntx * plan.nty
    ew_j = (entry_cov_j([(jnp.asarray(ce), jnp.asarray(c)) for ce, c in plan.chunk_pools],
                        ne, th, tw) + jnp.asarray(plan.entry_backdrop)[:, :, None])
    params, cts = [], []
    for te_b, _ids, flags in plan.tile_buckets:
        pp, ct = build_bucket_aux(plan, te_b, need_ct=bool(flags[2]))
        params.append(jnp.asarray(pp))
        cts.append(None if ct is None else jnp.asarray(ct))
    ref = np.asarray(composite_bucketed_pallas_body(
        ew_j, [(jnp.asarray(te), jnp.asarray(ids)) for te, ids, _fl in plan.tile_buckets],
        tuple(params), tuple(cts), jnp.asarray(np.asarray(BG, np.float32)),
        tile_h=th, tile_w=tw, num_tiles=nt, bucket_flags=host["bucket_flags"],
        interpret=True))
    d = _put({k: v for k, v in host.items() if k != "bucket_flags"}, "cpu")
    d["bucket_flags"] = host["bucket_flags"]
    img = execute_plan_flat(plan, d, [torch.from_numpy(c) for _, c in plan.chunk_pools],
                            BG, coverage)
    ref_img = ref.reshape(plan.nty, plan.ntx, th, tw, 4).transpose(0, 2, 1, 3, 4)
    ref_img = ref_img.reshape(plan.nty * th, plan.ntx * tw, 4)[:plan.height, :plan.width]
    assert img.shape == ref_img.shape == (H, W, 4)
    np.testing.assert_allclose(img.numpy(), ref_img, atol=2e-6, rtol=0)


@pytest.mark.parametrize("bits", [0, 1, 6, 8, 15, 16, 48, 64, 79, 113, 127])
def test_k7_instantiation_maps_lane_bits(bits):
    """K7's lane mask -> instantiation: the gradient, tri, texture and clip
    lanes (bits 0-3) pick one of 16 template instantiations, even-odd,
    non-AA and scissor (bits 4-6) pass as runtime bits; together they are
    the seven-bit mask the entry point takes."""
    from vgtpu_torch.ops.composite_flat_cuda import TEMPLATE_LANES, k7_instantiation

    flags = tuple(bool(bits >> i & 1) for i in range(7))
    g, rt = k7_instantiation(flags)
    assert TEMPLATE_LANES == 4
    assert g == bits & 15 and rt == bits & 112 and g | rt == bits
    with pytest.raises(ValueError, match="7 lane flags"):
        k7_instantiation(flags[:6])


@pytest.mark.parametrize("mo,npx,tile_w,add_backdrop,window,nbd", [
    (4, 8 * 128, 128, True, 4, 1), (32, 8 * 128, 128, True, 16, 1),
    (40, 8 * 128, 128, False, 17, 0), (1, 8 * 256, 256, True, 1, 1),
    (16, 8 * 16, 16, True, 16, 2), (8, 8 * 24, 24, True, 8, 3),
    (8, 2 * 24, 24, True, 8, 2), (0, 8 * 128, 128, True, 0, 1)])
def test_k7_geometry_stages_a_window_of_slot_tables(mo, npx, tile_w, add_backdrop,
                                                    window, nbd):
    """K7's launch geometry (csrc/composite_flat.cu geometry()): blocks of
    32 tiles x 32 pixels, grid = tile blocks x 32-pixel groups; per window
    of min(MO, 32) slots (fewer where 64 KB would not hold them) the params
    rows the bucket's instantiation reads (row_mask) and the backdrop rows
    a 32-pixel group spans (one row where tile_w is a multiple of 32, 32 /
    tile_w where it divides 32, else up to two more, never more than the
    tile's rows) for each of the block's 32 tiles, then the ew ring."""
    from vgtpu_torch.ops.composite_flat_cuda import k7_geometry

    g = k7_geometry(mo, npx, tile_w, 200, add_backdrop)
    assert g["grid"] == (7, -(-npx // 32))
    assert g["window"] == window and g["backdrop_rows"] == nbd
    assert g["staged_rows"] == 30 + nbd          # every lane: all 30 rows
    assert g["smem_bytes"] == 4 * (window * (30 + nbd) * 32 + 4 * 32 * 32)
    assert g["smem_bytes"] <= 232_448
    # a solid bucket stages 14 params rows, a gradient + triangle one 30
    for lanes, rows in ((0, 14), (1, 28), (2, 24), (3, 28), (8, 15), (11, 29)):
        assert k7_geometry(mo, npx, tile_w, 200, add_backdrop,
                           lanes)["staged_rows"] == rows + nbd
    # every row a group touches is staged
    for g0 in range(0, npx, 32):
        rows = {p // tile_w for p in range(g0, min(g0 + 32, npx))}
        assert not add_backdrop or len(rows) <= nbd
    with pytest.raises(ValueError, match="K7"):
        k7_geometry(4, 100, 128, 8, True)


@pytest.mark.parametrize("nbo,npx,narrow", [(12, 1024, True), (96, 1024, True),
                                             (128, 1024, True), (160, 1024, False),
                                             (384, 1024, False), (32, 8192, False)])
def test_k7_geometry_takes_narrow_blocks_on_small_grids(nbo, npx, narrow):
    """A bucket whose grid has fewer blocks than the card has SMs (132)
    takes K7's narrow form (2 pixels a thread, 512 threads), the others the
    wide one (4 pixels, 256 threads); both stage the same shared bytes."""
    from vgtpu_torch.ops.composite_flat_cuda import k7_geometry

    g = k7_geometry(16, npx, 128, nbo, True, 0)
    assert (g["grid"][0] * g["grid"][1] < 132) == narrow
    assert (g["pixels_per_thread"], g["threads"]) == ((2, 512) if narrow else (4, 256))
    assert g["smem_bytes"] == k7_geometry(16, npx, 128, nbo, True, 0,
                                          sms=0)["smem_bytes"]


def test_k7_row_mask_holds_every_row_an_instantiation_reads():
    """K7 stages only the params rows its instantiation reads: the rows the
    shared composite steps read for each lane (fill rule, AA, scissor,
    paint kind and origin, inner colour; kind on the clip lane, the
    colour-tile flag on the texture lane, the gradient's and the triangle's
    paint rows) are all in row_mask."""
    from vgtpu_torch.ops.composite import (
        _P_AA, _P_CTILE, _P_KIND, _P_OX, _P_OY, _P_PAINT, _P_PK, _P_RULE, _P_SC,
        _P_VALID)
    from vgtpu_torch.ops.composite_flat_cuda import META, row_mask

    base = {_P_VALID, _P_RULE, _P_AA, _P_PK, _P_OX, _P_OY,
            *range(_P_SC, _P_SC + 4), *range(_P_PAINT + 10, _P_PAINT + 14)}
    lane_rows = {8: {_P_KIND}, 4: {_P_CTILE},
                 1: {*range(_P_PAINT, _P_PAINT + 10), *range(_P_PAINT + 14, _P_PAINT + 18)},
                 2: set(range(_P_PAINT, _P_PAINT + 12))}
    for g in range(16):
        want = set(base)
        for bit, rows in lane_rows.items():
            if g & bit:
                want |= rows
        got = {r for r in range(META) if row_mask(g) >> r & 1}
        assert got == want
    assert row_mask(15) == (1 << META) - 1
