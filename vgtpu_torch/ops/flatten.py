"""Device-side curve flattening (the port of vgtpu/ops/flatten.py, plain
torch; vgtpu's is plain XLA).

The same Wang's-formula computation as PathBuilder.bake / vg_bake_path:
per-cubic segment counts from the second-difference bound, uniform-t
evaluation, and index-clamped t so every curve emits a FIXED max_n points;
curves needing fewer duplicate their endpoint, and the duplicated tail edges
contribute exactly zero coverage downstream (no masks, no compaction).
Runs on the control points' device and is differentiable.
"""

from __future__ import annotations

import torch


def flatten_cubics(cp: torch.Tensor, tol_d, max_n: int = 32) -> torch.Tensor:
    """cp: (C, 4, 2) control points -> (C, max_n+1, 2) polyline points
    (start point + max_n samples, tail clamped to the endpoint)."""
    d1 = cp[:, 0] - 2.0 * cp[:, 1] + cp[:, 2]
    d2 = cp[:, 1] - 2.0 * cp[:, 2] + cp[:, 3]
    m = torch.maximum(torch.linalg.vector_norm(d1, dim=1),
                      torch.linalg.vector_norm(d2, dim=1))
    n = torch.ceil(torch.sqrt(torch.clamp_min(3.0 * m / (4.0 * tol_d), 1.0)))
    n = torch.clamp(n, 1.0, float(max_n))                        # (C,)

    i = torch.arange(1, max_n + 1, dtype=torch.float32,
                     device=cp.device)[None, :]                  # (1, max_n)
    t = torch.minimum(i, n[:, None]) / n[:, None]                # clamped tail
    mt = 1.0 - t
    w0 = (mt ** 3)[..., None]
    w1 = (3.0 * mt * mt * t)[..., None]
    w2 = (3.0 * mt * t * t)[..., None]
    w3 = (t ** 3)[..., None]
    pts = (
        w0 * cp[:, None, 0] + w1 * cp[:, None, 1]
        + w2 * cp[:, None, 2] + w3 * cp[:, None, 3]
    )                                                            # (C, max_n, 2)
    return torch.cat([cp[:, None, 0], pts], dim=1)


def polyline_edges(pts: torch.Tensor, close: bool = True) -> torch.Tensor:
    """(..., N, 2) polyline -> (..., N or N-1, 4) edge segments."""
    nxt = torch.roll(pts, -1, dims=-2) if close else pts[..., 1:, :]
    cur = pts if close else pts[..., :-1, :]
    return torch.cat([cur, nxt], dim=-1)
