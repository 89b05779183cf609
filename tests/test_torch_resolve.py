"""The port's resolve-in-kernel coverage (vgtpu_torch/ops/coverage_resolve.py,
the plain twin of kernel K3) and its host tables (vgtpu_torch/raster/
resolve.py) against vgtpu's.

K3's TPU kernel (_kernel_t2_res) runs in interpret mode with unroll=1: it
then sums the edges one slot at a time, the order of the twin and of K3
(the default unroll reassociates the sum).  The resolve epilogue and the
ss-average are the same float32 expressions in the same order, so the twin
is held to 2e-6.  The host tables are numpy copies: bit-identical."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's thread pool oversubscribed them by orders of magnitude
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import vgtpu as vgj  # noqa: E402
from tests.test_coverage_resolve import _random_case  # noqa: E402
from vgtpu.ops.coverage import coverage_chunks_body  # noqa: E402
from vgtpu.ops.coverage_resolve import (  # noqa: E402
    coverage_chunks_pallas_res,
    resolve_cov_rows,
)
from vgtpu_torch.ops.coverage_resolve import (  # noqa: E402
    coverage_chunks_res_torch,
    cov_split_resolved,
    resolve_cov_rows_torch,
)
from vgtpu_torch.raster.binning import plan_from_numpy  # noqa: E402
from vgtpu_torch.raster.frame import _put  # noqa: E402

SS = 2
W, H = 512, 256


@pytest.mark.parametrize("ss,ch", [(2, 4), (2, 6), (4, 8), (2, 24), (2, 40),
                                   (2, 64)])
def test_k3_twin_matches_pallas_kernel(ss, ch):
    rng = np.random.default_rng(ss * 100 + ch)
    tile_h, tile_w, nc = 8 * ss, 128, 128
    edges, rp = _random_case(rng, nc, ch, tile_h, tile_w)
    ref = np.asarray(coverage_chunks_pallas_res(
        jnp.asarray(edges), jnp.asarray(rp), tile_h, tile_w, ss,
        interpret=True, unroll=1))
    got = coverage_chunks_res_torch(torch.from_numpy(edges),
                                    torch.from_numpy(rp), tile_h, tile_w, ss)
    assert got.shape == ref.shape == (nc, 8 * tile_w)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=0)


@pytest.mark.parametrize("ss,ch,tile_w", [(2, 8, 128), (2, 48, 128), (4, 24, 128),
                                          (2, 40, 256)])
def test_k3_live_edges_only_equal_the_dense_twin_bit_for_bit(ss, ch, tile_w):
    """The exactness of K3's sub-row culling: each sub-row's winding summed
    over its live edges only, then K3's epilogue (backdrop, even-odd,
    non-AA, texture, scissor, the ss-average), equals the dense twin bit
    for bit (torch.equal) on adversarial chunks."""
    from tests.test_torch_coverage import boundary_chunks, coverage_live_edges_only

    rng = np.random.default_rng(ss * 1000 + ch)
    tile_h, nc = 8 * ss, 96
    _e, rp = _random_case(rng, nc, ch, tile_h, tile_w)
    rp = torch.from_numpy(rp)
    for edges in (boundary_chunks(ss + ch, nc, ch, tile_h, tile_w), _e):
        e = torch.from_numpy(edges)
        dense = coverage_chunks_res_torch(e, rp, tile_h, tile_w, ss)
        live = resolve_cov_rows_torch(
            coverage_live_edges_only(e, tile_h, tile_w).reshape(nc, -1), rp,
            tile_h=tile_h, tile_w=tile_w, ss=ss)
        assert torch.equal(live, dense)


@pytest.mark.parametrize("ss", [2, 4])
def test_resolve_cov_rows_torch_matches_vgtpu(ss):
    rng = np.random.default_rng(7 + ss)
    tile_h, tile_w, n = 8 * ss, 128, 64
    edges, rp = _random_case(rng, n, 6, tile_h, tile_w)
    w = np.array(coverage_chunks_body(jnp.asarray(edges), tile_h, tile_w)
                 ).reshape(n, tile_h * tile_w)
    ref = np.asarray(resolve_cov_rows(jnp.asarray(w), jnp.asarray(rp),
                                      tile_h=tile_h, tile_w=tile_w, ss=ss))
    got = resolve_cov_rows_torch(torch.from_numpy(w), torch.from_numpy(rp),
                                 tile_h=tile_h, tile_w=tile_w, ss=ss)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=0)


@pytest.fixture(scope="module")
def split_plans():
    """tests/test_resolve_path.py's scene (every chunk class: RES, RAW-clip,
    XE, chunkless interiors) binned by vgtpu at ss=2 and handed to the port
    before any split; vgtpu then uploads its own copy through the fused
    path, _fused_platform monkeypatched on as that test does."""
    from tests.test_resolve_path import _scene
    from vgtpu.raster import frame as frame_mod
    from vgtpu.raster.binning import bin_frame

    ctx = vgj.createContext()
    vgj.begin(ctx, 0, W, H, 1.0)
    _scene(ctx)
    ctx._finalize_ops()
    plan_j = bin_frame(ctx.ops, W, H, tile_h=ctx.cfg.tile_h,
                       tile_w=ctx.cfg.tile_w, supersample=SS)
    ctx._fill_textures(plan_j)
    plan_t = plan_from_numpy(dataclasses.asdict(plan_j))
    mp = pytest.MonkeyPatch()
    mp.setattr(frame_mod, "_fused_platform", lambda: True)
    try:
        d_j = frame_mod.plan_to_device(plan_j)
    finally:
        mp.undo()
    from vgtpu_torch.raster.frame import plan_host_arrays

    host_t = plan_host_arrays(plan_t)
    return plan_j, d_j, plan_t, host_t


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def test_resolve_split_and_aux_bit_identical(split_plans):
    plan_j, d_j, plan_t, host_t = split_plans
    rj, rt = plan_j.resolve_host, plan_t.resolve_host
    assert rt["npools_res"] >= 1 and rt["nres"] > 0 and rt["nraw"] > 0
    assert rt["entry_flags"][:, 4].any(), "scene lost its clip tiles"
    for k in ("npools_res", "nres", "nraw"):
        assert rj[k] == rt[k], k
    for k in ("entry_res", "entry_ref", "entry_flags"):
        _eq(rj[k], rt[k], k)
    assert len(rj["rparams"]) == len(rt["rparams"])
    for a, b in zip(rj["rparams"], rt["rparams"]):
        _eq(a, b, "split rparams")
    assert plan_j.stats["chunks"] == plan_t.stats["chunks"]
    # the split pools, RES first, as the upload took them
    assert len(d_j["chunk_pools"]) == len(host_t["chunk_edges"])
    for (ce, _cent), ce_t in zip(d_j["chunk_pools"], host_t["chunk_edges"]):
        _eq(ce, ce_t, "chunk pool")
    res_j, res_t = d_j["res"], host_t["res"]
    for k in ("extra_chunk_raw", "extra_primary_raw", "xe_primary_raw",
              "xe_rparams"):
        _eq(res_j[k], res_t[k], k)
    assert (np.asarray(res_t["xe_primary_raw"]) < rt["nraw"]).any(), \
        "no multi-chunk (XE) entries in the scene"
    for a, b in zip(res_j["rparams"], res_t["rparams"]):
        _eq(a, b, "res rparams")
    assert len(res_j["pteb"]) == len(host_t["bucket_pteb"])
    for i, (pj, pt, rbj, rbt) in enumerate(zip(
            res_j["pteb"], host_t["bucket_pteb"], res_j["rbd"],
            host_t["bucket_rbd"])):
        _eq(pj, pt, f"bucket {i} pteb")
        assert (rbj is None) == (rbt is None), f"bucket {i} rbd"
        if rbj is not None:
            _eq(rbj, rbt, f"bucket {i} rbd")
    assert any(r is not None and r.any() for r in host_t["bucket_rbd"]), \
        "no chunkless interiors rode rbd"


def test_cov_split_resolved_matches_vgtpu(split_plans):
    from vgtpu.ops.coverage_resolve import cov_split_resolved as split_j

    plan_j, d_j, plan_t, host_t = split_plans
    th, tw = plan_t.tile_h, plan_t.tile_w
    fin_j, sub_j = split_j(d_j["chunk_pools"], d_j["res"], th, tw, SS)
    fin_t, sub_t = cov_split_resolved(_put(host_t["chunk_edges"], "cpu"),
                                      _put(host_t["res"], "cpu"), th, tw, SS)
    assert fin_t.shape == fin_j.shape and sub_t.shape == sub_j.shape
    assert torch.equal(fin_t[-1], torch.zeros(fin_t.shape[1]))
    np.testing.assert_allclose(sub_t.numpy(), np.asarray(sub_j), atol=2e-6, rtol=0)
    np.testing.assert_allclose(fin_t.numpy(), np.asarray(fin_j), atol=2e-6, rtol=0)


def test_cov_split_resolved_rejects_other_devices():
    e = torch.zeros((4, 2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cov_split_resolved([e], {"rparams": ()}, 16, 128, 2)


def test_k3_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run the plain twins: CPU tensors raise before
    any build or launch."""
    from vgtpu_torch.ops.coverage_resolve_cuda import (
        K3,
        coverage_chunks_res_cuda,
        resolve_rows_cuda,
    )

    x = torch.zeros((4, 2, 4))
    before = K3.launches
    with pytest.raises(ValueError, match="edges on cpu"):
        coverage_chunks_res_cuda([x], [x], x, 16, 128, 2)
    with pytest.raises(ValueError, match="cov_sub on cpu"):
        resolve_rows_cuda(x, x, x, x, 16, 128, 2)
    assert K3.launches == before


@pytest.mark.parametrize("ss", [1, 2, 4, 8])
@pytest.mark.parametrize("tile_h", [8, 16, 24, 32])
def test_k3_geometry_admits_every_tile_height(tile_h, ss):
    """K3 sizes its staging from the tile's sub-rows and the pool's CH:
    every tile height vgtpu admits at every ss, and every CH up to 64 (the
    native binner's largest pool in the chunk_pools=(2, 8, 48) frames is
    48), is admitted within the 227 KB a block may use, in one window.  Per
    chunk the edges (8 floats an edge) and sub-row masks (ceil(CH/32) words
    a sub-row) are dynamic shared memory; the rparams staging, RP_BD + 64
    floats per chunk, is static up to 64 sub-rows, and RP_BD + the window's
    sub-rows of dynamic memory above."""
    from vgtpu_torch.ops.coverage_cuda import edge_mask_bytes
    from vgtpu_torch.ops.coverage_resolve import RP_BD
    from vgtpu_torch.ops.coverage_resolve_cuda import SMEM_LIMIT, k3_geometry

    th = tile_h * ss                      # sub-rows
    for ch in (1, 2, 8, 24, 32, 33, 40, 48, 64):
        g = k3_geometry(th, ss, ch)
        assert g["window_rows"] == th and g["windows"] == 1
        assert g["staged_rows"] == RP_BD + max(th, 64)
        staging = 4 * g["chunks_per_block"] * g["staged_rows"]
        edges = 4 * g["chunks_per_block"] * (8 * ch + th * -(-ch // 32))
        assert edge_mask_bytes(ch, th) == edges
        static = staging if th <= 64 else 0
        assert g["smem_bytes"] == edges + (0 if th <= 64 else staging)
        assert g["shared_bytes"] == g["smem_bytes"] + static <= SMEM_LIMIT == 232_448
    with pytest.raises(ValueError, match="need ss"):
        k3_geometry(th + 1, ss, 2) if ss > 1 else k3_geometry(0, 1, 2)


@pytest.mark.parametrize("ss", [1, 2, 4, 8])
@pytest.mark.parametrize("ch", [2, 24, 48])
@pytest.mark.parametrize("tile_h", [256, 7_248, 8_192, 16_384, 65_536])
def test_k3_geometry_windows_tall_tiles(tile_h, ch, ss):
    """Tiles of any height (in sub-rows, a multiple of ss) are admitted: the
    masks and the rparams backdrop rows are staged for a window of whole
    output rows (a multiple of ss sub-rows), the whole tile where it fits,
    else the most that fit, within 227 KB."""
    from vgtpu_torch.ops.coverage_resolve import RP_BD
    from vgtpu_torch.ops.coverage_resolve_cuda import SMEM_LIMIT, k3_geometry

    g = k3_geometry(tile_h, ss, ch)
    win = g["window_rows"]
    assert win % ss == 0 and ss <= win <= tile_h
    assert g["windows"] == -(-tile_h // win)
    assert g["staged_rows"] == RP_BD + win
    assert g["shared_bytes"] <= SMEM_LIMIT
    row = 4 * g["chunks_per_block"] * (-(-ch // 32) + 1)
    assert win == tile_h or g["shared_bytes"] + ss * row > SMEM_LIMIT


def test_k3_geometry_refuses_what_the_card_cannot_hold():
    """Edge windows lift K3's depth ceiling: a chunk deeper than one window
    (EDGE_WINDOW = 512 edges) takes the deep form (one chunk a block, a
    warp per output row and 128 columns, each sub-row walked over windows
    of 512 edges, one window's scalars and 4 sub-rows' masks staged), so
    every CH is admitted, 1,753 (over the 1,752 the static form held),
    1,801 (over the 1,800 of the windowed form), 7,300 and 65,536 among
    them, at every ss and tile height; the shallow forms keep every CH up
    to the window.  Only ss not dividing the tile is refused."""
    from vgtpu_torch.ops.coverage_cuda import EDGE_WINDOW, deep_smem
    from vgtpu_torch.ops.coverage_resolve_cuda import SMEM_LIMIT, k3_geometry

    assert k3_geometry(7_256, 8, 2)["shared_bytes"] <= 232_448
    assert k3_geometry(8, 1, 1_700)["form"] == "deep"
    for tile_h, ss in ((8, 1), (64, 8), (128, 2), (16_384, 2)):
        assert k3_geometry(tile_h, ss, EDGE_WINDOW)["form"] == "shallow"
        assert k3_geometry(tile_h, ss, EDGE_WINDOW)["shared_bytes"] <= SMEM_LIMIT
        for ch in (EDGE_WINDOW + 1, 1_753, 1_801, 1_809, 7_300, 65_536):
            g = k3_geometry(tile_h, ss, ch)
            assert g["form"] == "deep" and g["edge_window"] == EDGE_WINDOW
            assert g["chunks_per_block"] == 1 and g["threads"] == 128
            assert g["smem_bytes"] == g["shared_bytes"] == deep_smem(EDGE_WINDOW, 4)
            assert g["smem_bytes"] <= SMEM_LIMIT
    with pytest.raises(ValueError, match="need ss"):
        k3_geometry(7_257, 8, 2)
    with pytest.raises(ValueError, match="need ss"):
        k3_geometry(130, 4, 2_048)
