"""Differentiable rendering (vgtpu_torch/diff.py), device-side flattening
(ops/flatten.py) and utils/profiler.trace_frame on the CPU.

The cases of tests/test_diff.py, with torch autograd where vgtpu takes
jax.grad; render_edges' image held to vgtpu's within 1e-5 and its gradients
with respect to the shapes' vertices and colours to jax.grad's within 1e-4
(on a loss whose gradients reach 0.4 to 130), and with respect to free edge
endpoints within 1e-4 off the pixels whose winding the two packages round
to the two sides of a kink of the fill rule; flatten_cubics and polyline_edges held to vgtpu's on
tests/test_path.py::test_device_flatten_matches_host's inputs."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import vgtpu.diff as dj  # noqa: E402
from vgtpu.ops.coverage import _edge_contribution as contribution_j  # noqa: E402
from vgtpu.ops import flatten as fj  # noqa: E402
from vgtpu_torch.diff import cubic_edges, polygon_edges, render_edges  # noqa: E402
from vgtpu_torch.ops.coverage import _edge_contribution  # noqa: E402
from vgtpu_torch.ops.flatten import flatten_cubics, polyline_edges  # noqa: E402

ATOL_IMG = 1e-5
ATOL_GRAD = 1e-4
# a winding this close to a kink of the fill rule (|w| at 0 or 1 for
# non-zero, an integer for even-odd) may round to either side of it
KINK_TOL = 1e-4


def _tri(cx, cy, r):
    ang = torch.tensor([0.0, 2.1, 4.2])
    return torch.stack([cx + r * torch.cos(ang), cy + r * torch.sin(ang)], dim=1)


def test_gradients_flow_to_geometry():
    pts = _tri(16.0, 16.0, 8.0).requires_grad_(True)
    colors = torch.tensor([[1.0, 0.0, 0.0, 1.0]])
    img = render_edges(polygon_edges(pts), colors,
                       torch.zeros(3, dtype=torch.long), 32, 32)
    img[..., 3].sum().backward()          # total coverage
    g = pts.grad
    assert torch.isfinite(g).all()
    # growing the triangle outward must increase area
    p = pts.detach()
    center = p.mean(dim=0)
    radial = (p - center) / torch.linalg.vector_norm(p - center, dim=1, keepdim=True)
    assert float((g * radial).sum()) > 0.1


def test_fit_circle_position():
    """Recover a shape's position from a target image by gradient descent."""
    colors = torch.tensor([[1.0, 1.0, 1.0, 1.0]])
    shape_ids = torch.zeros(3, dtype=torch.long)
    target = render_edges(polygon_edges(_tri(20.0, 14.0, 9.0)), colors,
                          shape_ids, 32, 32)
    off = torch.tensor([4.0, -3.0], requires_grad=True)
    for _ in range(60):
        img = render_edges(polygon_edges(_tri(20.0, 14.0, 9.0) + off), colors,
                           shape_ids, 32, 32)
        loss = ((img - target) ** 2).mean()
        (g,) = torch.autograd.grad(loss, off)
        with torch.no_grad():
            off -= 40.0 * g
    assert float(torch.linalg.vector_norm(off.detach())) < 0.5, off


def test_gradient_wrt_color():
    c = torch.tensor([0.5, 0.5, 0.5, 1.0], requires_grad=True)
    img = render_edges(polygon_edges(_tri(16.0, 16.0, 8.0)), c[None, :],
                       torch.zeros(3, dtype=torch.long), 32, 32)
    img[..., 0].sum().backward()
    assert c.grad[0] > 1.0          # more red -> more red
    assert abs(float(c.grad[1])) < 1e-6   # green channel independent


def test_cubic_edges_gradient_and_batching():
    ctrl = torch.tensor([[4.0, 4.0], [12.0, 28.0], [20.0, -4.0], [28.0, 24.0]])
    e = cubic_edges(ctrl, samples=8)
    assert e.shape == (8, 4)
    torch.testing.assert_close(e[1:, 0:2], e[:-1, 2:4], atol=1e-6, rtol=0)
    torch.testing.assert_close(e[0, 0:2], ctrl[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(e[-1, 2:4], ctrl[3], atol=1e-6, rtol=0)
    assert cubic_edges(torch.stack([ctrl, ctrl]), samples=5).shape == (2, 5, 4)
    want = np.asarray(dj.cubic_edges(jnp.asarray(ctrl.numpy()), samples=8))
    np.testing.assert_allclose(e.numpy(), want, atol=1e-5, rtol=0)


def test_fit_cubic_control_point():
    """Recover a perturbed Bezier control point from pixels: cubic_edges +
    render_edges, differentiated end to end."""
    base = torch.tensor([[4.0, 16.0], [12.0, 2.0], [20.0, 30.0], [28.0, 16.0]])
    colors = torch.tensor([[1.0, 1.0, 1.0, 1.0]])
    ids = torch.zeros(13, dtype=torch.long)

    def img_of(ctrl):
        edges = torch.cat([cubic_edges(ctrl, 12),
                           torch.cat([ctrl[3], ctrl[0]])[None, :]])
        return render_edges(edges, colors, ids, 32, 32)

    target = img_of(base)
    d = torch.tensor([5.0, -4.0], requires_grad=True)
    for _ in range(80):
        ctrl = base.clone()
        ctrl[1] = ctrl[1] + d
        loss = ((img_of(ctrl) - target) ** 2).mean()
        (g,) = torch.autograd.grad(loss, d)
        with torch.no_grad():
            d -= 300.0 * g
    assert float(torch.linalg.vector_norm(d)) < 1.0, d


def _scene(seed):
    """Three closed shapes as vertex lists (two triangles and a rectangle on
    integer coordinates, where the coverage sits exactly on its kinks),
    random colours, a background and per-pixel loss weights."""
    rng = np.random.default_rng(seed)
    ang = np.array([0.0, 2.1, 4.2])
    tris = [np.stack([cx + r * np.cos(ang + a), cy + r * np.sin(ang + a)], 1)
            for cx, cy, r, a in ((10, 12, 7, 0.3), (20, 18, 9, 1.1))]
    rect = np.array([[4, 4], [28, 4], [28, 10], [4, 10]], np.float64)
    shapes = [p.astype(np.float32) for p in tris + [rect]]
    ids = np.repeat(np.arange(3), [len(p) for p in shapes]).astype(np.int32)
    cols = rng.uniform(0.2, 1.0, (3, 4)).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3, 1.0], np.float32)
    weights = rng.uniform(size=(32, 32, 4)).astype(np.float32)
    return shapes, ids, cols, bg, weights


@pytest.mark.parametrize("fill_rule", [0, 1], ids=["nonzero", "evenodd"])
def test_render_edges_and_gradients_match_jax(fill_rule):
    """The gradients are taken with respect to the shapes' vertices (edges
    through polygon_edges, as a fit moves them) and the colours.  With
    respect to one edge's endpoints alone they can differ at pixels inside
    a shape, where the winding sums to 1 within an ulp: min(|w|, 1) has a
    kink there, and the two packages round w to different sides of it
    (their images agree to ~6e-8); moving a shared vertex moves both its
    edges, and those contributions cancel."""
    shapes, ids, cols, bg, w = _scene(fill_rule)

    def loss_j(pts, c):
        e = jnp.concatenate([dj.polygon_edges(p) for p in pts])
        img = dj.render_edges(e, c, jnp.asarray(ids), 32, 32, fill_rule,
                              jnp.asarray(bg))
        return jnp.sum(img * w), img

    (_, img_j), (gp_j, gc_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(
            [jnp.asarray(p) for p in shapes], jnp.asarray(cols))
    pts = [torch.tensor(p, requires_grad=True) for p in shapes]
    c = torch.tensor(cols, requires_grad=True)
    e = torch.cat([polygon_edges(p) for p in pts])
    img = render_edges(e, c, torch.tensor(ids), 32, 32, fill_rule,
                       torch.tensor(bg))
    (img * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_j),
                               atol=ATOL_IMG, rtol=0)
    for k, (p, g) in enumerate(zip(pts, gp_j)):
        assert float(np.abs(np.asarray(g)).max()) > 0.05, k   # not all zero
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g),
                                   atol=ATOL_GRAD, rtol=0, err_msg=str(k))
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(gc_j),
                               atol=ATOL_GRAD, rtol=0)


def _windings(edges: np.ndarray, ids: np.ndarray, n: int, port: bool) -> np.ndarray:
    """(n, 32, 32) winding of each shape in either package."""
    if port:
        px = torch.arange(32.0)[None, None, :]
        py = torch.arange(32.0)[None, :, None]
        e = torch.tensor(edges)[:, :, None, None]
        c = _edge_contribution(px, py, e[:, 0], e[:, 1], e[:, 2], e[:, 3])
        return torch.zeros(n, 32, 32).index_add(0, torch.tensor(ids).long(), c).numpy()
    px, py = jnp.arange(32.0)[None, :], jnp.arange(32.0)[:, None]
    c = jax.vmap(lambda e: contribution_j(px, py, e[0], e[1], e[2], e[3]))(
        jnp.asarray(edges))
    return np.asarray(jax.ops.segment_sum(c, jnp.asarray(ids), num_segments=n))


def _near_kink(w: np.ndarray, fill_rule: int) -> np.ndarray:
    a = np.abs(w)
    if fill_rule == 0:
        return (a < KINK_TOL) | (np.abs(a - 1.0) < KINK_TOL)
    return np.abs(w - np.round(w)) < KINK_TOL


@pytest.mark.parametrize("fill_rule", [0, 1], ids=["nonzero", "evenodd"])
def test_edge_gradients_match_jax_off_the_kink(fill_rule):
    """Gradients with respect to free edge endpoints ((E, 4) edges, each
    endpoint its own variable) and the colours, on _scene's shapes and a
    self-intersecting star (winding 2 inside).  cov is min(|w|, 1)
    (non-zero) or a triangle wave (even-odd) of each shape's winding w, with
    kinks at |w| = 0 and 1 and at the integers.  Inside a shape w sums to 1
    within an ulp; where the two packages' w differ there, they lie on the
    kink's two sides and the subgradient jumps.  The gradients are held to
    jax.grad's within 1e-4 on the loss over every other pixel: each shape's
    windings equal in both packages, or both at least KINK_TOL from a kink.
    The pixels left out (at most 5%) and the largest edge gradient
    difference with them in are printed (pytest -s)."""
    shapes, ids, cols, bg, weights = _scene(fill_rule)
    ang = np.linspace(0.0, 2.0 * np.pi, 6)[:-1] + 0.4
    star = np.stack([16.2 + 11.3 * np.cos(2 * ang), 15.7 + 11.3 * np.sin(2 * ang)], 1)
    shapes = shapes + [star.astype(np.float32)]
    ids = np.concatenate([ids, np.full(5, 3, np.int32)])
    cols = np.concatenate([cols, [[0.9, 0.4, 0.2, 0.7]]]).astype(np.float32)
    edges = np.concatenate([np.concatenate([p, np.roll(p, -1, axis=0)], 1)
                            for p in shapes]).astype(np.float32)
    wt, wj = (_windings(edges, ids, 4, port) for port in (True, False))
    split = ((wt != wj) & (_near_kink(wt, fill_rule) | _near_kink(wj, fill_rule))).any(0)
    assert split.sum() <= 0.05 * split.size, int(split.sum())
    grads = {}
    for name, mask in (("off", ~split), ("all", np.ones_like(split))):
        wm = weights * mask[..., None]

        def loss_j(e, c, wm=wm):
            img = dj.render_edges(e, c, jnp.asarray(ids), 32, 32, fill_rule,
                                  jnp.asarray(bg))
            return jnp.sum(img * wm)

        ge_j, gc_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(edges),
                                                     jnp.asarray(cols))
        e = torch.tensor(edges, requires_grad=True)
        c = torch.tensor(cols, requires_grad=True)
        img = render_edges(e, c, torch.tensor(ids), 32, 32, fill_rule, torch.tensor(bg))
        (img * torch.tensor(wm)).sum().backward()
        grads[name] = (e.grad.numpy(), np.asarray(ge_j), c.grad.numpy(), np.asarray(gc_j))
    ge_t, ge_j, gc_t, gc_j = grads["off"]
    assert float(np.abs(ge_j).max()) > 0.05                # not all zero
    np.testing.assert_allclose(ge_t, ge_j, atol=ATOL_GRAD, rtol=0)
    np.testing.assert_allclose(gc_t, gc_j, atol=ATOL_GRAD, rtol=0)
    full = grads["all"]
    print(f"\nfill rule {fill_rule}: {int(split.sum())} of {split.size} pixels on a "
          f"split kink; off them, edge gradients {np.abs(ge_t - ge_j).max():.4e} apart "
          f"(largest {np.abs(ge_j).max():.3f}); with them in, "
          f"{np.abs(full[0] - full[1]).max():.4e} (largest {np.abs(full[1]).max():.3f})")


def test_flatten_cubics_matches_vgtpu():
    """tests/test_path.py::test_device_flatten_matches_host's curves, tail
    clamping included, and a tolerance given as a tensor."""
    rng = np.random.default_rng(21)
    cps = rng.uniform(5, 120, (6, 4, 2)).astype(np.float32)
    want = np.asarray(fj.flatten_cubics(jnp.asarray(cps), 0.5, max_n=48))
    got = flatten_cubics(torch.tensor(cps), 0.5, max_n=48)
    assert got.shape == (6, 49, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # clamped tails repeat the endpoint exactly
    np.testing.assert_array_equal(got[:, -1].numpy(), cps[:, 3])
    got_t = flatten_cubics(torch.tensor(cps), torch.tensor(0.5), max_n=48)
    assert torch.equal(got_t, got)
    for close in (True, False):
        e = polyline_edges(got, close=close)
        want_e = np.asarray(fj.polyline_edges(jnp.asarray(got.numpy()), close=close))
        np.testing.assert_array_equal(e.numpy(), want_e)


def test_trace_frame_writes_a_trace(tmp_path):
    import vgtpu_torch as vg
    from vgtpu_torch.utils.profiler import trace_frame

    ctx = vg.createContext(device="cpu")
    logdir = str(tmp_path / "trace")
    with trace_frame(logdir) as prof:
        vg.begin(ctx, 0, 128, 64, 1.0)
        vg.beginPath(ctx)
        vg.circle(ctx, 64, 32, 20)
        vg.fillPath(ctx, vg.Colors.White, vg.FillFlags.ConvexAA)
        vg.end(ctx)
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(ev.get("ph") == "X" for ev in events)
    assert len(prof.key_averages()) > 0
