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


@pytest.mark.parametrize("ch", [2, 4, 8, 24])
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

@pytest.mark.parametrize("ch", [2, 4, 6, 24])
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

@pytest.mark.parametrize("ch", [2, 6, 24])
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

@pytest.mark.parametrize("ch", [2, 6, 24])
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
