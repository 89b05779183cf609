"""The port's chunk coverage (vgtpu_torch/ops/coverage.py) against vgtpu's:
the plain twin vs the XLA body and the Pallas TPU kernel in interpret mode
(K1's reference), the extras fold vs vgtpu's cov_all_resolved, the
pixel-major twin (K4's) and the entry segment-sum of the sharded paths vs
vgtpu's _kernel_t2 and entry_coverage_from_pools, and the entry points of
K6 (coverage_chunks vs coverage_chunks_pallas) and K5
(coverage_chunks_t(variant="flat") vs _kernel_t).

Tolerance atol=1e-5: both sides evaluate the same float32 expressions in the
same order, with the two FMAs XLA contracts written out in the twin; what is
left is a few ulps on coverage values of magnitude <= CH."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's thread pool oversubscribed them by orders of magnitude
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from vgtpu.ops.coverage import coverage_chunks_body  # noqa: E402
from vgtpu.ops.coverage_pallas import coverage_chunks_pallas_rt_raw  # noqa: E402
from vgtpu_torch.ops.coverage import (  # noqa: E402
    cov_all,
    cov_all_torch,
    coverage_chunks_torch,
)

TH, TW = 8, 128


def random_chunks(seed: int, nc: int, ch: int) -> np.ndarray:
    """(nc, ch, 4) tile-local edges with the hard cases mixed in: horizontal,
    near-vertical (|m| < 0.01), |dy| below the 1e-6 guard, zero-length,
    out-of-tile (left, right, above, below) and zero pad edges."""
    rng = np.random.default_rng(seed)
    e = np.stack([
        rng.uniform(-20, TW + 20, (nc, ch)),
        rng.uniform(-4, TH + 4, (nc, ch)),
        rng.uniform(-20, TW + 20, (nc, ch)),
        rng.uniform(-4, TH + 4, (nc, ch)),
    ], axis=-1)
    kind = rng.integers(0, 8, (nc, ch))
    x0, y0 = e[..., 0], e[..., 1]
    e[..., 3] = np.where(kind == 1, y0, e[..., 3])                     # horizontal
    e[..., 2] = np.where(kind == 2, x0 + rng.uniform(-0.05, 0.05, (nc, ch)),
                         e[..., 2])                                     # near-vertical
    e[..., 3] = np.where(kind == 3, y0 + 5e-7, e[..., 3])               # |dy| < 1e-6
    e[..., 2:4] = np.where((kind == 4)[..., None], e[..., 0:2], e[..., 2:4])  # zero length
    e[..., 0] = np.where(kind == 5, -30.0, e[..., 0])                   # left of tile
    e[..., 2] = np.where(kind == 5, -10.0, e[..., 2])
    e[..., 1] = np.where(kind == 6, TH + 3.0, e[..., 1])                # below the tile
    e[..., 3] = np.where(kind == 6, TH + 9.0, e[..., 3])
    e[..., :] = np.where((kind == 7)[..., None], 0.0, e)                # pad edge
    return e.astype(np.float32)


@pytest.mark.parametrize("ch", [2, 4, 8, 24])
def test_coverage_chunks_torch_matches_xla_body(ch):
    edges = random_chunks(ch, 64, ch)
    ref = np.asarray(coverage_chunks_body(jnp.asarray(edges), TH, TW))
    got = coverage_chunks_torch(torch.from_numpy(edges), TH, TW).numpy()
    assert got.shape == (64, TH, TW)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("ch", [2, 4, 8, 24, 40, 64])
def test_coverage_chunks_torch_matches_pallas_kernel(ch):
    """K1's TPU kernel (_kernel_t2_rt) in interpret mode, chunk-major.
    unroll=1 sums the edges one slot at a time, the order of the scan, the
    twin and K1: the default unroll reassociates the sum, and XLA's FMA
    choices then differ inside the G-form, whose 1/m amplifies an ulp of u
    up to 100x on these adversarial near-vertical edges (~1e-4)."""
    edges = random_chunks(100 + ch, 128, ch)
    ref = np.asarray(coverage_chunks_pallas_rt_raw(
        jnp.asarray(edges), TH, TW, interpret=True, unroll=1))
    got = coverage_chunks_torch(torch.from_numpy(edges), TH, TW)
    np.testing.assert_allclose(got.reshape(128, TH * TW).numpy(), ref,
                               atol=1e-5, rtol=0)


def _small_scene_plan():
    """The small scene + text recorded through vgtpu, binned by the port."""
    import vgtpu as vgj
    from tests.fontdata import FONT_DATA
    from vgtpu_torch.raster.binning import bin_frame
    from vgtpu_torch.scenes.small import draw_small_scene

    ctx = vgj.createContext(vgj.ContextConfig(device_sampling=False))
    vgj.begin(ctx, 0, 512, 256, 1.0)
    draw_small_scene(ctx, FONT_DATA, vg=vgj)
    ctx._finalize_ops()
    return bin_frame(ctx.ops, 512, 256)


def test_coverage_pools_match_pallas_default_unroll():
    """The production Pallas call (default unroll) on a real frame's pools."""
    for ce, _cent in _small_scene_plan().chunk_pools:
        n = len(ce)
        npad = -(-n // 128) * 128
        edges = np.zeros((npad,) + ce.shape[1:], np.float32)
        edges[:n] = ce
        ref = np.asarray(coverage_chunks_pallas_rt_raw(
            jnp.asarray(edges), TH, TW, interpret=True))
        got = coverage_chunks_torch(torch.from_numpy(edges), TH, TW)
        np.testing.assert_allclose(got.reshape(npad, -1).numpy(), ref,
                                   atol=1e-5, rtol=0)


def test_cov_all_layout_and_dead_row():
    pools = [torch.from_numpy(random_chunks(s, n, ch))
             for s, (n, ch) in enumerate([(16, 2), (8, 4), (0, 8), (4, 24)])]
    out = cov_all(pools, TH, TW)
    assert out.shape == (16 + 8 + 0 + 4 + 1, TH * TW)
    assert torch.equal(out[-1], torch.zeros(TH * TW))
    row = 0
    for p in pools:
        n = p.shape[0]
        ref = coverage_chunks_torch(p, TH, TW).reshape(n, TH * TW)
        assert torch.equal(out[row:row + n], ref)
        row += n
    assert torch.equal(cov_all_torch(pools, TH, TW), out)


def test_cov_all_rejects_other_devices():
    pools = [torch.zeros((4, 2, 4), device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        cov_all(pools, TH, TW)


def boundary_chunks(seed: int, nc: int, ch: int, th: int, tw: int) -> np.ndarray:
    """(nc, ch, 4) edges that probe the row culling of K1 and K3: endpoints
    on row boundaries (integer y, so h is exactly 0 or 1 at the ends),
    horizontal edges on and between rows, near-vertical edges with |m|
    around the 0.01 steep threshold, edges wholly left and wholly right of
    the tile, edges above and below it, and zero pad edges."""
    rng = np.random.default_rng(seed)
    e = np.stack([rng.uniform(-20, tw + 20, (nc, ch)),
                  rng.integers(-2, th + 3, (nc, ch)).astype(np.float64),
                  rng.uniform(-20, tw + 20, (nc, ch)),
                  rng.integers(-2, th + 3, (nc, ch)).astype(np.float64)], axis=-1)
    kind = rng.integers(0, 9, (nc, ch))
    x0, y0 = e[..., 0], e[..., 1]
    frac = rng.uniform(0, 1, (nc, ch))
    e[..., 3] = np.where(kind == 1, y0 + np.where(frac < 0.5, 0.0, frac), e[..., 3])
    e[..., 1] = np.where(kind == 1, e[..., 3], e[..., 1])            # horizontal
    dy = e[..., 3] - e[..., 1]
    m = rng.choice([-0.0101, -0.01, -0.0099, 0.0099, 0.01, 0.0101], (nc, ch))
    e[..., 2] = np.where(kind == 2, x0 + m * dy, e[..., 2])          # |m| ~ 0.01
    e[..., 0] = np.where(kind == 3, -40.0, e[..., 0])                # left of tile
    e[..., 2] = np.where(kind == 3, -5.0, e[..., 2])
    e[..., 0] = np.where(kind == 4, tw + 5.0, e[..., 0])             # right of it
    e[..., 2] = np.where(kind == 4, tw + 30.0, e[..., 2])
    e[..., 1] = np.where(kind == 5, -7.0, e[..., 1])                 # above it
    e[..., 3] = np.where(kind == 5, 0.0, e[..., 3])
    e[..., 1] = np.where(kind == 6, th + 0.0, e[..., 1])             # below it
    e[..., 3] = np.where(kind == 6, th + 5.5, e[..., 3])
    e[..., :] = np.where((kind == 7)[..., None], 0.0, e)             # pad edge
    return e.astype(np.float32)


def coverage_live_edges_only(chunk_edges: torch.Tensor, tile_h: int,
                             tile_w: int) -> torch.Tensor:
    """coverage_chunks_torch's expressions evaluated as K1 and K3 walk them:
    the row part (ytop, h, x(ytop)) once per (edge, row), the column part
    per pixel, and an edge added to a row only where it is live there
    (edge_row_live, the kernels' masks); elsewhere the accumulator is left
    as it was."""
    from vgtpu_torch.ops.coverage import edge_row_live, fma

    nc, ch, _ = chunk_edges.shape
    live = edge_row_live(chunk_edges, tile_h)               # (NC, CH, TH)
    px = torch.arange(tile_w, dtype=torch.float32)          # (TW,)
    py = torch.arange(tile_h, dtype=torch.float32)[:, None]  # (TH, 1)
    acc = torch.zeros((nc, tile_h, tile_w), dtype=torch.float32)
    for e in range(ch):
        x0, y0, x1, y1 = (chunk_edges[:, e, k][:, None, None] for k in range(4))
        dy = y1 - y0
        s = torch.sign(dy)
        m = (x1 - x0) / torch.where(torch.abs(dy) < 1e-6, 1.0, dy)
        steep = torch.abs(m) < 0.01
        s_over_m = s / torch.where(steep, 1.0, m)
        ytop = torch.maximum(torch.minimum(y0, y1), py)      # (NC, TH, 1)
        h = torch.clamp_min(torch.minimum(torch.maximum(y0, y1), py + 1.0) - ytop, 0.0)
        xt = fma(m, ytop - y0, x0)                           # the row part
        u0 = (px + 1.0) - xt
        u1 = fma(-m, h, u0)
        c0, c1 = torch.clamp(u0, 0.0, 1.0), torch.clamp(u1, 0.0, 1.0)
        g = (c0 * (u0 - 0.5 * c0) - c1 * (u1 - 0.5 * c1)) * s_over_m
        term = torch.where(steep, s * h * c0, g)
        acc = torch.where(live[:, e, :, None], acc + term, acc)
    return acc


@pytest.mark.parametrize("ch", [2, 8, 24, 40, 64])
@pytest.mark.parametrize("th,tw", [(8, 128), (16, 128), (8, 256)])
def test_live_edges_only_equal_the_dense_twin_bit_for_bit(th, tw, ch):
    """The exactness of K1's row culling: skipping every (edge, row) pair
    with h == 0 leaves each pixel's edge-order sum bit for bit as the dense
    twin's (torch.equal), on adversarial chunks (boundary_chunks) and on
    random_chunks' hard cases."""
    for edges in (boundary_chunks(ch * th + tw, 96, ch, th, tw),
                  random_chunks(7 * ch + th, 96, ch)):
        e = torch.from_numpy(edges)
        dense = coverage_chunks_torch(e, th, tw)
        live = coverage_live_edges_only(e, th, tw)
        assert torch.equal(live, dense)
    # the culling is not vacuous: dead pairs and live pairs both occur
    from vgtpu_torch.ops.coverage import edge_row_live

    frac = float(edge_row_live(torch.from_numpy(
        boundary_chunks(ch * th + tw, 96, ch, th, tw)), th).float().mean())
    assert 0.05 < frac < 0.8


def coverage_windowed_walk(chunk_edges: torch.Tensor, tile_h: int, tile_w: int,
                           window: int) -> torch.Tensor:
    """coverage_live_edges_only walked as K1, K3 and K4 walk a tile taller
    than their staging window: the row masks of rows r0 .. r0 + window - 1
    only (edge_row_live from row0 = r0), those rows accumulated, then the
    next window; a window's masks never cover another's rows."""
    from vgtpu_torch.ops.coverage import edge_row_live, fma

    nc, ch, _ = chunk_edges.shape
    px = torch.arange(tile_w, dtype=torch.float32)
    acc = torch.zeros((nc, tile_h, tile_w), dtype=torch.float32)
    for r0 in range(0, tile_h, window):
        nr = min(window, tile_h - r0)
        live = edge_row_live(chunk_edges, nr, row0=r0)          # (NC, CH, nr)
        py = torch.arange(r0, r0 + nr, dtype=torch.float32)[:, None]
        win = torch.zeros((nc, nr, tile_w), dtype=torch.float32)
        for e in range(ch):
            x0, y0, x1, y1 = (chunk_edges[:, e, k][:, None, None] for k in range(4))
            dy = y1 - y0
            s = torch.sign(dy)
            m = (x1 - x0) / torch.where(torch.abs(dy) < 1e-6, 1.0, dy)
            steep = torch.abs(m) < 0.01
            s_over_m = s / torch.where(steep, 1.0, m)
            ytop = torch.maximum(torch.minimum(y0, y1), py)
            h = torch.clamp_min(torch.minimum(torch.maximum(y0, y1), py + 1.0) - ytop,
                                0.0)
            xt = fma(m, ytop - y0, x0)
            u0 = (px + 1.0) - xt
            u1 = fma(-m, h, u0)
            c0, c1 = torch.clamp(u0, 0.0, 1.0), torch.clamp(u1, 0.0, 1.0)
            g = (c0 * (u0 - 0.5 * c0) - c1 * (u1 - 0.5 * c1)) * s_over_m
            term = torch.where(steep, s * h * c0, g)
            win = torch.where(live[:, e, :, None], win + term, win)
        acc[:, r0:r0 + nr] = win
    return acc


@pytest.mark.parametrize("th,window", [(64, 8), (64, 24), (48, 16), (40, 40)])
def test_windowed_walk_equals_the_dense_twin_bit_for_bit(th, window):
    """The exactness of windowed staging: a tile taller than the staging
    window, walked one window of row masks at a time (the last window
    shorter where the window does not divide the tile), equals the dense
    twin bit for bit (torch.equal) in K1's layout and, transposed, K4's
    twin; on boundary_chunks over the tall tile and random_chunks."""
    from vgtpu_torch.ops.coverage import coverage_chunks_t_torch

    for edges in (boundary_chunks(th + window, 32, 24, th, TW),
                  random_chunks(th * window, 32, 8)):
        e = torch.from_numpy(edges)
        walked = coverage_windowed_walk(e, th, TW, window)
        assert torch.equal(walked, coverage_chunks_torch(e, th, TW))
        assert torch.equal(walked.reshape(e.shape[0], -1).t(),
                           coverage_chunks_t_torch(e, th, TW))


def coverage_edge_window_walk(chunk_edges: torch.Tensor, tile_h: int,
                              tile_w: int, row_window: int,
                              edge_window: int) -> torch.Tensor:
    """The deep form's walk (csrc/edge_coverage.cuh::walk_deep and K3's):
    per window of rows, the chunk's edges a window of edge_window edges at a
    time, each window's masks (edge_row_live of the window's edges over the
    window's rows), its live edges added in edge order to the sums carried
    from the last edge window as stored floats."""
    from vgtpu_torch.ops.coverage import edge_row_live, fma

    nc, ch, _ = chunk_edges.shape
    px = torch.arange(tile_w, dtype=torch.float32)
    out = torch.zeros((nc, tile_h, tile_w), dtype=torch.float32)
    for r0 in range(0, tile_h, row_window):
        nr = min(row_window, tile_h - r0)
        py = torch.arange(r0, r0 + nr, dtype=torch.float32)[:, None]
        for e0 in range(0, ch, edge_window):
            win = chunk_edges[:, e0:e0 + edge_window]
            live = edge_row_live(win, nr, row0=r0)          # the window's masks
            acc = out[:, r0:r0 + nr].clone()                # the carried sums
            for i in range(win.shape[1]):
                x0, y0, x1, y1 = (win[:, i, k][:, None, None] for k in range(4))
                dy = y1 - y0
                s = torch.sign(dy)
                m = (x1 - x0) / torch.where(torch.abs(dy) < 1e-6, 1.0, dy)
                steep = torch.abs(m) < 0.01
                s_over_m = s / torch.where(steep, 1.0, m)
                ytop = torch.maximum(torch.minimum(y0, y1), py)
                h = torch.clamp_min(torch.minimum(torch.maximum(y0, y1), py + 1.0)
                                    - ytop, 0.0)
                u0 = (px + 1.0) - fma(m, ytop - y0, x0)
                u1 = fma(-m, h, u0)
                c0, c1 = torch.clamp(u0, 0.0, 1.0), torch.clamp(u1, 0.0, 1.0)
                g = (c0 * (u0 - 0.5 * c0) - c1 * (u1 - 0.5 * c1)) * s_over_m
                term = torch.where(steep, s * h * c0, g)
                acc = torch.where(live[:, i, :, None], acc + term, acc)
            out[:, r0:r0 + nr] = acc
    return out


@functools.lru_cache(maxsize=8)
def _dense_chunks(ch: int, th: int) -> tuple:
    """boundary_chunks and random_chunks of ch edges over a th x 128 tile,
    each with its dense twins (chunk-major and pixel-major)."""
    from vgtpu_torch.ops.coverage import coverage_chunks_t_torch

    nc = 2 if ch > 1_000 else 6
    out = []
    for edges in (boundary_chunks(ch + th, nc, ch, th, TW),
                  random_chunks(3 * ch + th, nc, ch)):
        e = torch.from_numpy(edges)
        out.append((e, coverage_chunks_torch(e, th, TW),
                    coverage_chunks_t_torch(e, th, TW)))
    return tuple(out)


@pytest.mark.parametrize("ch", [33, 64, 100, 2_100])
@pytest.mark.parametrize("edge_window", [32, 64])
@pytest.mark.parametrize("th,row_window", [(16, 8), (24, 16)])
def test_edge_window_walk_equals_the_dense_twins_bit_for_bit(th, row_window,
                                                             edge_window, ch):
    """The exactness of edge windows: a chunk deeper than one window, its
    edges staged and walked a window at a time inside windows of rows (that
    divide the tile or not), the sums carried from window to window as
    floats, equals the dense twin bit for bit (torch.equal) in K1's and
    K6's layout and, transposed, K4's and K5's, on boundary_chunks and
    random_chunks; the culling is not vacuous (live and dead pairs)."""
    from vgtpu_torch.ops.coverage import edge_row_live

    for e, dense, dense_t in _dense_chunks(ch, th):
        walked = coverage_edge_window_walk(e, th, TW, row_window, edge_window)
        assert torch.equal(walked, dense)
        assert torch.equal(walked.reshape(e.shape[0], -1).t(), dense_t)
        frac = float(edge_row_live(e, th).float().mean())
        assert 0.01 < frac < 0.9


@pytest.mark.parametrize("ch", [1, 2, 8, 24, 32, 33, 40, 48, 64])
@pytest.mark.parametrize("tile_h,tile_w", [(8, 128), (8, 256), (16, 128),
                                           (32, 256), (256, 128)])
def test_k1_geometry_admits_every_ch_and_tile_shape(tile_h, tile_w, ch):
    """K1 takes every CH up to and over the binner's largest (48 in the
    chunk_pools=(2, 8, 48) frames) at every tile vgtpu admits (tile_w 128
    or 256, tile_h a multiple of 8; K1 runs the RAW pools on sub-rows, up
    to tile_h 32 at ss = 8): per chunk 8 floats an edge and ceil(CH/32)
    mask words a row of dynamic shared memory, within 227 KB."""
    from vgtpu_torch.ops.coverage_cuda import SMEM_LIMIT, k1_geometry

    g = k1_geometry(tile_h, tile_w, ch)
    assert g["window_rows"] == tile_h and g["windows"] == 1
    assert g["smem_bytes"] == g["shared_bytes"] == (
        4 * g["chunks_per_block"] * (8 * ch + tile_h * -(-ch // 32)))
    assert g["smem_bytes"] <= SMEM_LIMIT == 232_448
    assert g["threads"] == 128


@pytest.mark.parametrize("ch", [2, 8, 24, 32, 33, 48])
@pytest.mark.parametrize("tile_h", [8, 256, 7_072, 14_512, 14_520, 16_384, 65_536])
def test_k1_geometry_admits_every_tile_height(tile_h, ch):
    """K1 stages its row masks a window of rows at a time, so every tile
    height vgtpu admits is taken: the whole tile in one window where its
    masks fit the card (up to 14,512 rows at CH = 2, 7,072 at CH = 48: the
    tiles K1 took before windows), else windows of the most rows that fit,
    the staging within 227 KB whatever the height."""
    from vgtpu_torch.ops.coverage_cuda import SMEM_LIMIT, edge_mask_bytes, k1_geometry

    g = k1_geometry(tile_h, 128, ch)
    win = g["window_rows"]
    assert 1 <= win <= tile_h and g["windows"] == -(-tile_h // win)
    assert g["smem_bytes"] == edge_mask_bytes(ch, win) <= SMEM_LIMIT
    if edge_mask_bytes(ch, tile_h) <= SMEM_LIMIT:
        assert win == tile_h                       # one window, as before
    else:
        assert edge_mask_bytes(ch, win + 1) > SMEM_LIMIT   # the most that fit
    assert (win == 14_512) == (ch == 2 and tile_h >= 14_512)


def test_k1_geometry_refuses_what_the_card_cannot_hold():
    """Edge windows lift K1's depth ceiling: a chunk deeper than one window
    (EDGE_WINDOW = 512 edges) takes the deep form, one chunk a block and
    its edges staged a window at a time, so every CH is admitted (1,809,
    over the 1,808 the shallow staging held, up to 65,536) within 227 KB
    at any tile height; the shallow form keeps every CH up to the window.
    Only a tile width that is not a multiple of 128 is refused."""
    from vgtpu_torch.ops.coverage_cuda import (
        EDGE_WINDOW,
        SMEM_LIMIT,
        deep_smem,
        k1_geometry,
    )

    assert EDGE_WINDOW == 512 and EDGE_WINDOW % 32 == 0
    assert k1_geometry(8, 128, EDGE_WINDOW)["form"] == "shallow"
    assert k1_geometry(8, 128, EDGE_WINDOW)["window_rows"] == 8
    for ch in (EDGE_WINDOW + 1, 1_753, 1_801, 1_809, 7_300, 65_536):
        for tile_h, tile_w in ((8, 128), (16, 256), (65_536, 128)):
            g = k1_geometry(tile_h, tile_w, ch)
            assert g["form"] == "deep" and g["edge_window"] == EDGE_WINDOW
            assert g["chunks_per_block"] == 1 and g["threads"] == 128
            assert g["window_rows"] == min(tile_h, 4)
            assert g["smem_bytes"] == deep_smem(EDGE_WINDOW, g["window_rows"])
            assert g["smem_bytes"] <= SMEM_LIMIT
            assert g["grid_y"] == min(-(-tile_h * (tile_w // 128) // 4), 65_535)
    with pytest.raises(ValueError, match="multiple of 128"):
        k1_geometry(8, 192, 8)
    with pytest.raises(ValueError, match="multiple of 128"):
        k1_geometry(8, 192, 2_048)


@pytest.mark.parametrize("ch", [1, 2, 24, 32, 33, 48, 64, 226, 1_753, 1_801,
                                1_809, 7_300, 65_536])
def test_k4_geometry_admits_every_ch_the_card_holds(ch):
    """K4's shallow form stages, per block of cpb chunks and a window of at
    most 8 rows, the edge scalars (32 bytes an edge), the row masks and 8
    warps' transpose buffers of 128 pixels x (cpb + 1) floats in dynamic
    shared memory sized at launch: 8 chunks a block (one 32-byte sector
    per pixel's store) throughout the edge window (512 edges).  Deeper
    chunks take the deep form (one chunk a block, edges staged a window at
    a time, one float a pixel stored: no transpose), so every CH is
    admitted, 7,300 (over the 6,980 one shallow chunk held) and 65,536
    among them.  A tile width that is not a multiple of 128 is refused."""
    from vgtpu_torch.ops.coverage_cuda import EDGE_WINDOW, deep_smem
    from vgtpu_torch.ops.coverage_t_cuda import SMEM_LIMIT, k4_geometry, k4_smem

    g = k4_geometry(8, 128, ch)
    assert g["threads"] == 256 and g["smem_bytes"] == g["shared_bytes"] <= SMEM_LIMIT
    if ch <= EDGE_WINDOW:
        cpb = g["chunks_per_block"]
        assert g["form"] == "shallow" and cpb == 8 and g["edge_window"] == 0
        assert g["window_rows"] == 8 and g["grid_y"] == 1
        assert g["smem_bytes"] == k4_smem(ch, cpb, 8) == 4 * (
            cpb * (8 * ch + 8 * -(-ch // 32)) + 8 * 128 * (cpb + 1))
    else:
        assert g["form"] == "deep" and g["chunks_per_block"] == 1
        assert g["edge_window"] == EDGE_WINDOW and g["window_rows"] == 8
        assert g["smem_bytes"] == deep_smem(EDGE_WINDOW, 8)
        assert g["grid_y"] == 1 and k4_geometry(8, 256, ch)["grid_y"] == 2
    assert k4_geometry(8, 128, EDGE_WINDOW)["chunks_per_block"] == 8
    with pytest.raises(ValueError, match="multiple of 128"):
        k4_geometry(8, 192, ch)


@pytest.mark.parametrize("tile_h", [1, 3, 8, 16, 256, 16_384, 65_536, 600_000])
def test_k4_geometry_windows_any_tile_height(tile_h):
    """K4's window is at most 8 rows (fewer for a shorter tile); blocks along
    grid.y, at most 65,535 of them, stride over the tile's windows, so the
    staging does not grow with the tile and every height launches."""
    from vgtpu_torch.ops.coverage_t_cuda import k4_geometry

    g = k4_geometry(tile_h, 256, 24)
    assert g["window_rows"] == min(tile_h, 8)
    assert g["grid_y"] == min(-(-tile_h // g["window_rows"]), 65_535)
    assert g["smem_bytes"] == k4_geometry(8, 128, 24)["smem_bytes"] or tile_h < 8


def test_k4_pool_packing_takes_its_own_chunks_per_block():
    """K4's launch packs its pools as K1's does (deepest first, at most
    MAX_POOLS a launch) with its own chunks per block: block prefixes of
    ceil(NC / 8) blocks, each pool's descriptor pointing at its own output
    (the row is unused); a block prefix counted with another chunks per
    block is what the card's read_pools refuses."""
    from vgtpu_torch.ops.coverage_cuda import MAX_POOLS, pack_pools

    shapes = [(100, 2), (33, 8), (0, 24), (64, 48)]
    (descs,) = pack_pools(shapes, 8)
    assert [(i, b) for i, _r, b in descs] == [(3, 0), (1, 8), (0, 13)]
    assert pack_pools(shapes, 8) != pack_pools(shapes)
    launches = pack_pools([(40, 2 + i) for i in range(MAX_POOLS + 3)], 8)
    assert [len(d) for d in launches] == [MAX_POOLS, 3]
    assert [b for _i, _r, b in launches[1]] == [0, 5, 10]


def test_pack_pools_block_prefix_rows_and_order():
    """One launch over every pool: each descriptor names its pool, the
    pool's first output row (pools' rows follow one another in pool order)
    and its first block (the prefix of ceil(NC / 4) blocks, deepest pool
    first); empty pools get no descriptor; the dead row is a (1, 0) pool."""
    from vgtpu_torch.ops.coverage_cuda import MAX_POOLS, pack_pools

    shapes = [(16, 2), (8, 4), (0, 8), (5, 24), (1, 0)]
    (descs,) = pack_pools(shapes)
    assert descs == [(3, 24, 0), (1, 16, 2), (0, 0, 4), (4, 29, 8)]
    assert MAX_POOLS == 8
    assert pack_pools([(0, 2), (0, 8)]) == []


def test_pack_pools_splits_a_long_tuple_into_several_launches():
    """A pool tuple longer than the descriptor array is never refused: it
    takes several launches, each with its own block prefix from 0, which
    together cover every pool's rows once."""
    from vgtpu_torch.ops.coverage_cuda import MAX_POOLS, pack_pools

    shapes = [(4 * i + 1, 2 + i) for i in range(11)] + [(1, 0)]
    launches = pack_pools(shapes)
    assert [len(d) for d in launches] == [MAX_POOLS, 4]
    seen = sorted(d for launch in launches for d in launch)
    assert [i for i, _r, _b in seen] == list(range(12))
    rows = np.cumsum([0] + [nc for nc, _ch in shapes])[:-1]
    assert [r for _i, r, _b in seen] == rows.tolist()
    for launch in launches:
        blocks = [b for _i, _r, b in launch]
        sizes = [-(-shapes[i][0] // 4) for i, _r, _b in launch]
        assert blocks == np.cumsum([0] + sizes)[:-1].tolist()
        chs = [shapes[i][1] for i, _r, _b in launch]
        assert chs == sorted(chs, reverse=True)
    # the deepest pools take the first launch: pools 10 (41 chunks, 11
    # blocks), 9 (37, 10 blocks), 8 (33), ...
    assert launches[0][:3] == [(10, int(rows[10]), 0), (9, int(rows[9]), 11),
                               (8, int(rows[8]), 21)]


def test_k1_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain twin: a CPU tensor raises
    before any build or launch."""
    from vgtpu_torch.ops.coverage_cuda import K1, cov_all_cuda

    before = K1.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        cov_all_cuda([torch.zeros((4, 2, 4))], TH, TW)
    assert K1.launches == before


def test_cov_all_resolved_matches_vgtpu():
    """The extras fold (gather + index_add_) vs vgtpu's .at[].add on a real
    plan with multi-chunk entries (the small scene + text)."""
    from vgtpu.ops.coverage import build_cov_gather_map as build_map_j
    from vgtpu.ops.coverage import cov_all_resolved as resolved_j
    from vgtpu_torch.ops.coverage import build_cov_gather_map, cov_all_resolved

    plan = _small_scene_plan()
    ne = plan.entry_backdrop.shape[0]
    m = build_cov_gather_map(plan.chunk_pools, ne)
    mj = build_map_j(plan.chunk_pools, ne)
    for k in m:
        np.testing.assert_array_equal(m[k], mj[k])
    dead_id = sum(len(cent) for _ce, cent in plan.chunk_pools)
    assert (m["extra_chunk"] != dead_id).any()   # real extras fold
    ref = np.asarray(resolved_j(
        [(jnp.asarray(ce), jnp.asarray(cent)) for ce, cent in plan.chunk_pools],
        {k: jnp.asarray(v) for k, v in mj.items()}, TH, TW))
    got = cov_all_resolved(
        [torch.from_numpy(ce) for ce, _cent in plan.chunk_pools],
        {k: torch.from_numpy(v) for k, v in m.items()}, TH, TW)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


# ---- K4: pixel-major coverage and the entry segment-sum ----------------------

@pytest.mark.parametrize("ch", [2, 4, 6, 24, 40, 64])
def test_coverage_chunks_t_torch_matches_pallas_kernel(ch):
    """K4's TPU kernel (_kernel_t2, variant "row") in interpret mode,
    pixel-major; unroll=1 for the reason given above."""
    from vgtpu.ops.coverage_pallas import coverage_chunks_pallas_t_raw

    from vgtpu_torch.ops.coverage import coverage_chunks_t_torch

    edges = random_chunks(200 + ch, 128, ch)
    ref = np.asarray(coverage_chunks_pallas_t_raw(
        jnp.asarray(edges), TH, TW, interpret=True, unroll=1))
    got = coverage_chunks_t_torch(torch.from_numpy(edges), TH, TW)
    assert got.shape == (TH * TW, 128)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    # the same values as K1's twin, transposed, bit for bit
    k1 = coverage_chunks_torch(torch.from_numpy(edges), TH, TW).reshape(128, -1)
    assert torch.equal(got, k1.t())


def test_coverage_t_pools_match_pallas_default_unroll():
    from vgtpu.ops.coverage_pallas import coverage_chunks_pallas_t_raw

    from vgtpu_torch.ops.coverage import coverage_chunks_t

    for ce, _cent in _small_scene_plan().chunk_pools:
        n = len(ce)
        npad = -(-n // 128) * 128
        edges = np.zeros((npad,) + ce.shape[1:], np.float32)
        edges[:n] = ce
        ref = np.asarray(coverage_chunks_pallas_t_raw(
            jnp.asarray(edges), TH, TW, interpret=True))
        got = coverage_chunks_t(torch.from_numpy(edges), TH, TW)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_coverage_pools_t_matches_pallas_kernel_per_pool():
    """coverage_pools_t, the one-call form the sharded paths take (one K4
    launch over every pool on CUDA), gives each pool's pixel-major coverage
    as vgtpu's _kernel_t2 does (interpret mode), pools in order; other
    devices are refused."""
    from vgtpu.ops.coverage_pallas import coverage_chunks_pallas_t_raw

    from vgtpu_torch.ops.coverage import coverage_pools_t

    pools = [np.ascontiguousarray(ce) for ce, _cent in _small_scene_plan().chunk_pools]
    got = coverage_pools_t([torch.from_numpy(ce) for ce in pools], TH, TW)
    assert len(got) == len(pools) > 1
    for ce, cov in zip(pools, got):
        n = len(ce)
        npad = -(-n // 128) * 128
        edges = np.zeros((npad,) + ce.shape[1:], np.float32)
        edges[:n] = ce
        ref = np.asarray(coverage_chunks_pallas_t_raw(
            jnp.asarray(edges), TH, TW, interpret=True))[:, :n]
        assert cov.shape == (TH * TW, n)
        np.testing.assert_allclose(cov.numpy(), ref, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        coverage_pools_t([torch.zeros((4, 2, 4), device="meta")], TH, TW)


def test_entry_coverage_from_pools_matches_vgtpu():
    """The per-pool segment-sum (index_add_ over chunks, pools in order) vs
    vgtpu's segment_sum on the small scene + text, which has multi-chunk
    entries and several pools."""
    from vgtpu.ops.coverage import entry_coverage_from_pools as entry_cov_j

    from vgtpu_torch.ops.coverage import entry_coverage_from_pools

    plan = _small_scene_plan()
    ne = plan.entry_backdrop.shape[0]
    assert len(plan.chunk_pools) > 1
    ref = np.asarray(entry_cov_j(
        [(jnp.asarray(ce), jnp.asarray(cent)) for ce, cent in plan.chunk_pools],
        ne, TH, TW))
    got = entry_coverage_from_pools(
        [torch.from_numpy(ce) for ce, _cent in plan.chunk_pools],
        [torch.from_numpy(cent) for _ce, cent in plan.chunk_pools], ne, TH, TW)
    assert got.shape == (ne, TH, TW)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_k4_wrapper_refuses_cpu_tensors_and_other_devices():
    """The CUDA wrapper never runs the plain twin; the dispatcher refuses
    devices other than CUDA and the CPU."""
    from vgtpu_torch.ops.coverage import coverage_chunks_t
    from vgtpu_torch.ops.coverage_t_cuda import K4, coverage_chunks_t_cuda

    before = K4.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        coverage_chunks_t_cuda(torch.zeros((4, 2, 4)), TH, TW)
    assert K4.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        coverage_chunks_t(torch.zeros((4, 2, 4), device="meta"), TH, TW)


# ---- K6: chunk coverage, edge slot by edge slot --------------------------------

@pytest.mark.parametrize("ch", [2, 6, 24, 40, 64])
def test_coverage_chunks_matches_pallas_kernel(ch):
    """K6's TPU kernel (_kernel, coverage_chunks_pallas) in interpret mode:
    its grid accumulates the output slot by slot, the order of the twin."""
    from vgtpu.ops.coverage_pallas import coverage_chunks_pallas

    from vgtpu_torch.ops.coverage import coverage_chunks

    edges = random_chunks(300 + ch, 128, ch)
    ref = np.asarray(coverage_chunks_pallas(jnp.asarray(edges), TH, TW,
                                            interpret=True))
    got = coverage_chunks(torch.from_numpy(edges), TH, TW)
    assert got.shape == ref.shape == (128, TH, TW)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


# ---- K5: pixel-major coverage, the flat form -------------------------------------

@pytest.mark.parametrize("ch", [2, 6, 24, 40, 64])
def test_coverage_chunks_t_flat_matches_pallas_kernel(ch):
    """K5's TPU kernel (_kernel_t, variant "flat") in interpret mode at
    unroll=1.  It equals K4's (_kernel_t2) bit for bit, so K4's twin is
    K5's, within K4's tolerance (measured 1.4e-6 on these adversarial
    chunks, the same against either kernel)."""
    from vgtpu.ops.coverage_pallas import coverage_chunks_pallas_t_raw

    from vgtpu_torch.ops.coverage import coverage_chunks_t, coverage_chunks_t_torch

    edges = random_chunks(400 + ch, 128, ch)
    ref = np.asarray(coverage_chunks_pallas_t_raw(
        jnp.asarray(edges), TH, TW, interpret=True, unroll=1, variant="flat"))
    ref_row = np.asarray(coverage_chunks_pallas_t_raw(
        jnp.asarray(edges), TH, TW, interpret=True, unroll=1, variant="row"))
    np.testing.assert_array_equal(ref, ref_row)
    got = coverage_chunks_t(torch.from_numpy(edges), TH, TW, variant="flat")
    assert got.shape == ref.shape == (TH * TW, 128)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    assert torch.equal(got, coverage_chunks_t_torch(torch.from_numpy(edges), TH, TW))


def test_coverage_t_flat_pools_match_pallas_default_unroll():
    from vgtpu.ops.coverage_pallas import coverage_chunks_pallas_t_raw

    from vgtpu_torch.ops.coverage import coverage_chunks_t

    for ce, _cent in _small_scene_plan().chunk_pools:
        n = len(ce)
        npad = -(-n // 128) * 128
        edges = np.zeros((npad,) + ce.shape[1:], np.float32)
        edges[:n] = ce
        ref = np.asarray(coverage_chunks_pallas_t_raw(
            jnp.asarray(edges), TH, TW, interpret=True, variant="flat"))
        got = coverage_chunks_t(torch.from_numpy(edges), TH, TW, variant="flat",
                                unroll=0)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_coverage_chunks_t_refuses_unknown_variant():
    from vgtpu_torch.ops.coverage import coverage_chunks_t

    with pytest.raises(ValueError, match="unknown variant 'rows'"):
        coverage_chunks_t(torch.zeros((4, 2, 4)), TH, TW, variant="rows")


@pytest.mark.parametrize("kernel", ["K5", "K6"])
def test_k5_k6_wrappers_refuse_cpu_tensors_and_other_devices(kernel):
    """The CUDA wrappers never run the plain twin: a CPU tensor raises
    before any build or launch; the dispatchers refuse devices other than
    CUDA and the CPU."""
    from vgtpu_torch.ops import coverage, coverage_slots_cuda, coverage_t_flat_cuda

    if kernel == "K5":
        k, wrapper = coverage_t_flat_cuda.K5, coverage_t_flat_cuda.coverage_chunks_t_flat_cuda

        def dispatch(e):
            return coverage.coverage_chunks_t(e, TH, TW, variant="flat")
    else:
        k, wrapper = coverage_slots_cuda.K6, coverage_slots_cuda.coverage_chunks_slots_cuda

        def dispatch(e):
            return coverage.coverage_chunks(e, TH, TW)
    before = k.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        wrapper(torch.zeros((4, 2, 4)), TH, TW)
    assert k.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        dispatch(torch.zeros((4, 2, 4), device="meta"))


@pytest.mark.parametrize("ch", [1, 2, 24, 64, 512, 513, 2_048, 8_192, 65_536])
@pytest.mark.parametrize("tile_h,tile_w", [(8, 128), (8, 256), (16, 128),
                                           (64, 256), (16_384, 128)])
def test_k6_geometry_admits_any_ch_and_tile_shape(tile_h, tile_w, ch):
    """K6 takes K1's design for one pool: up to the edge window (512 edges)
    K1's shallow geometry (4 chunks a block, windows of rows), with the
    block's raw edges (16 bytes an edge, one bulk copy) and an mbarrier in
    its shared memory too; deeper, K1's deep form (one chunk a block, edge
    windows).  Every CH and tile shape fits the card either way; a tile
    width that is not a multiple of 128 is refused."""
    from vgtpu_torch.ops.coverage_cuda import (
        EDGE_WINDOW,
        SMEM_LIMIT,
        deep_smem,
        edge_mask_bytes,
        k1_geometry,
    )
    from vgtpu_torch.ops.coverage_slots_cuda import k6_geometry

    k1 = k1_geometry(tile_h, tile_w, ch)
    g = k6_geometry(tile_h, tile_w, ch)
    assert g["smem_bytes"] <= SMEM_LIMIT
    assert g["form"] == k1["form"] == ("shallow" if ch <= EDGE_WINDOW else "deep")
    if ch > EDGE_WINDOW:
        assert g == k1
        assert g["chunks_per_block"] == 1 and g["edge_window"] == EDGE_WINDOW
        assert g["smem_bytes"] == deep_smem(EDGE_WINDOW, min(tile_h, 4))
    else:
        win = g["window_rows"]
        assert g["smem_bytes"] == edge_mask_bytes(ch, win) + 4 * 4 * 4 * ch + 16
        assert 1 <= win <= k1["window_rows"]
    with pytest.raises(ValueError, match="multiple of 128"):
        k6_geometry(tile_h, 192, ch)


@pytest.mark.parametrize("ch", [1, 2, 24, 64, 512, 513, 2_048, 8_192, 65_536])
@pytest.mark.parametrize("tile_h,tile_w", [(8, 128), (8, 256), (16, 128),
                                           (64, 256), (16_384, 128)])
def test_k5_geometry_admits_any_ch_and_tile_shape(tile_h, tile_w, ch):
    """K5 takes K4's design for one pool and K4's geometry: up to the edge
    window K4's shallow form (cpb chunks a block, windows of at most 8 rows
    along grid.y), deeper the deep form (one chunk a block, edge windows,
    no transpose).  Every CH and tile shape fits the card; a tile width
    that is not a multiple of 128 is refused."""
    from vgtpu_torch.ops.coverage_cuda import EDGE_WINDOW, SMEM_LIMIT, deep_smem
    from vgtpu_torch.ops.coverage_t_cuda import k4_geometry, k4_smem
    from vgtpu_torch.ops.coverage_t_flat_cuda import k5_geometry

    g = k5_geometry(tile_h, tile_w, ch)
    assert g == k4_geometry(tile_h, tile_w, ch) and g["smem_bytes"] <= SMEM_LIMIT
    assert g["form"] == ("shallow" if ch <= EDGE_WINDOW else "deep")
    if ch > EDGE_WINDOW:
        assert g["chunks_per_block"] == 1 and g["edge_window"] == EDGE_WINDOW
        assert g["smem_bytes"] == deep_smem(EDGE_WINDOW, min(tile_h, 8))
    else:
        cpb, rows = g["chunks_per_block"], g["window_rows"]
        assert g["smem_bytes"] == k4_smem(ch, cpb, rows)
        assert rows == min(tile_h, 8) and cpb == 8
        assert g["grid_y"] == min(-(-tile_h // rows), 65_535)
    with pytest.raises(ValueError, match="multiple of 128"):
        k5_geometry(tile_h, 192, ch)
