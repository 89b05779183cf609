"""Differentiable vector rendering (the port of vgtpu/diff.py).

The analytic coverage formula (ops/coverage._edge_contribution) is smooth in
the edge coordinates almost everywhere, so gradients flow from pixels back
to control points through torch autograd, where vgtpu uses jax.grad over the
same expressions: no reparameterization tricks needed (the box-filter AA is
the softening).  Dense and unbinned: for optimization loops over small
scenes, not production frames.  No kernel sits under it, so it is plain
torch on whatever device its inputs live on.

Typical use: fit path control points, colours or transforms to a target
image with loss.backward() through `render_edges`.
"""

from __future__ import annotations

import torch

from vgtpu_torch.ops.coverage import _edge_contribution


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with jax's gradient at 0 (+1; torch.abs gives 0 there, which
    would drop every pixel whose winding sums to exactly 0)."""
    return torch.where(x >= 0, x, -x)


def render_edges(edges: torch.Tensor, colors: torch.Tensor,
                 edge_shape: torch.Tensor, width: int, height: int,
                 fill_rule: int = 0,
                 background: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable multi-shape renderer.

    edges: (E, 4) f32 segments; edge_shape: (E,) integer shape id per edge
    (shapes composite in id order); colors: (S, 4) straight-alpha RGBA;
    fill_rule 0 is non-zero, anything else even-odd.  Returns (H, W, 4)
    premultiplied on the edges' device.

    Gradients match vgtpu's jax.grad except at a pixel where a shape's
    winding sits on a kink of the fill rule (|w| = 1 inside a non-zero
    shape, an integer for even-odd) and the two round it to its two sides,
    a last-bit difference: there the subgradient of the free edge endpoints
    jumps.  Vertices shared by two edges (polygon_edges) cancel it."""
    width, height, fill_rule = int(width), int(height), int(fill_rule)
    dev = edges.device
    n_shapes = colors.shape[0]
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, None, :]
    py = torch.arange(height, dtype=torch.float32, device=dev)[None, :, None]
    e = edges[:, :, None, None]
    contrib = _edge_contribution(px, py, e[:, 0], e[:, 1], e[:, 2], e[:, 3])
    # segment_sum over the shape ids; out of place, so autograd sees it
    w = torch.zeros((n_shapes, height, width), dtype=contrib.dtype,
                    device=dev).index_add(0, edge_shape.long(), contrib)
    if fill_rule == 0:
        # minimum, not clamp: at |w| == 1 the gradient splits in half, as
        # jax's does
        cov = torch.minimum(_abs(w), w.new_ones(()))
    else:
        cov = 1.0 - _abs(torch.remainder(w, 2.0) - 1.0)

    if background is None:
        background = torch.zeros(4, dtype=torch.float32, device=dev)
    fb = background.to(torch.float32).expand(height, width, 4)
    for i in range(n_shapes):          # the painter's scan
        col = colors[i]
        a = col[3] * cov[i]
        rgb = col[0:3] * a[..., None]
        fb = torch.cat([rgb + fb[..., 0:3] * (1.0 - a)[..., None],
                        (a + fb[..., 3] * (1.0 - a))[..., None]], dim=-1)
    return fb


def polygon_edges(pts: torch.Tensor) -> torch.Tensor:
    """(N,2) closed polygon -> (N,4) differentiable edge array."""
    nxt = torch.roll(pts, -1, dims=0)
    return torch.cat([pts, nxt], dim=1)


def cubic_edges(ctrl: torch.Tensor, samples: int = 16) -> torch.Tensor:
    """Differentiable cubic-Bezier flattening: (..., 4, 2) control points ->
    (..., samples, 4) edge segments at uniform parameter steps.

    The production flattener (geometry/path.py, Wang-count subdivision) runs
    in numpy on the host; this fixed-count sampler is its differentiable twin
    for optimization loops.  Leading batch axes broadcast, so a whole path of
    S cubics is `cubic_edges(ctrl_S42).reshape(-1, 4)`."""
    t = torch.linspace(0.0, 1.0, samples + 1, dtype=ctrl.dtype,
                       device=ctrl.device)                      # (K+1,)
    u = 1.0 - t
    # Bernstein basis (K+1, 4)
    basis = torch.stack([u ** 3, 3 * u ** 2 * t, 3 * u * t ** 2, t ** 3], dim=1)
    pts = torch.einsum("kc,...cd->...kd", basis, ctrl)          # (..., K+1, 2)
    return torch.cat([pts[..., :-1, :], pts[..., 1:, :]], dim=-1)
