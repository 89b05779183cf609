# Frozen copy of vgtpu_torch/geometry/path.py for the benchmark's plain reference: the
# port's host semantics as of the benchmark's first version, importing
# nothing of the program, so a later change to the port cannot move the
# yardstick.
"""Path building: verbs -> flattened polylines (the reference's src/path.cpp).

The reference flattens each cubic with a recursive-descent De Casteljau loop and
an explicit stack (path.cpp:86-182) — inherently sequential.  Here every verb is
*recorded*, and `bake()` flattens ALL curves of the path in one vectorized pass:

  - cubics: Wang's-formula segment counts + uniform-t evaluation.  For a cubic
    with control points p0..p3, the max second difference
    m = max(|p0-2p1+p2|, |p1-2p2+p3|) bounds the flattening error of an
    n-segment uniform polyline by 3m/(4n^2), so
        n = ceil(sqrt(3m / (4 * tol_d)))
    guarantees error <= tol_d with no recursion, no data-dependent control flow
    — the same computation runs in numpy here and in jnp on device.
  - arcs/circles/ellipses: incremental-angle sampling with the reference's
    segment-density law  da = 2*acos(s*r / (s*r + tol))  (path.cpp:599-682).

Tolerance mapping: the reference's flatness test (path.cpp:112-116) accepts when
(d2+d3)^2 <= tessTol*|chord|^2 with tessTol = tol/scale^2 (path.cpp:105), which
bounds the control-point deviation by sqrt(tol)/scale local units; we use
tol_d = sqrt(tess_tol)/scale for the same effective density.

Quadratics are elevated to cubics exactly as path.cpp:184-201.
Vertex dedup follows pathAddVertex/pathClose (path.cpp:707-784): consecutive
points closer than sqrt(VG_EPSILON) collapse; closing dedupes last==first.
"""

from __future__ import annotations

import math

import numpy as np

from vgbench.reference.core import VG_EPSILON, Winding

# verb codes
V_MOVE = 0
V_LINE = 1
V_CUBIC = 2
V_ARC = 3    # cx, cy, rx, ry, a0, a1  (sampled a0 -> a1 inclusive endpoints)
V_CLOSE = 4
V_POLY = 5   # offset, count into the poly coordinate pool

_PI2 = math.pi * 2.0


def _arc_da(radius: float, scale: float, tol: float) -> float:
    """Reference angular step law (path.cpp:602,654)."""
    sr = scale * max(radius, 1e-6)
    return math.acos(max(-1.0, min(1.0, sr / (sr + tol)))) * 2.0


class PathBuilder:
    """Records path verbs; bake() produces (vertices, subpaths).

    Mirrors the public seam of include/vg/path.h:19-38 (createPath/pathMoveTo/
    .../pathGetVertices/pathGetSubPaths) with identical verb semantics.
    """


    def __init__(self) -> None:
        self._scale = 1.0
        self._tol = 0.25
        self._gen = 0
        self.reset(1.0, 0.25)

    @property
    def n_verbs(self) -> int:
        return len(self._verbs)

    @property
    def version(self):
        """Changes whenever recorded content can differ: the stream is
        append-only within one reset generation, so (generation, verb count)
        identifies it (Context caches the transformed bake by this)."""
        return (self._gen, len(self._verbs))

    # -- lifecycle ---------------------------------------------------------
    def reset(self, scale: float, tess_tol: float) -> None:
        self._scale = float(scale)
        self._tol = float(tess_tol)
        self._gen += 1
        self._verbs: list[int] = []
        # flat per-type argument streams (fast C-level np conversion at bake)
        self._simple_flat: list[float] = []   # MOVE/LINE: x,y
        self._cubic_flat: list[float] = []    # p0..p3: 8 floats
        self._arc_flat: list[float] = []      # cx,cy,rx,ry,a0,a1
        self._poly_args: list[tuple] = []     # (offset, count)
        self._poly_pool: list[np.ndarray] = []
        self._poly_pool_len = 0
        # record-time state for arcTo/arc and subpath bookkeeping
        self._cur = (0.0, 0.0)
        self._subpath_open = False      # a subpath exists
        self._subpath_nverts = 0        # vertices in the current subpath
        self._baked: tuple[np.ndarray, np.ndarray] | None = None

    # -- verbs (path.cpp parity) ------------------------------------------
    def move_to(self, x: float, y: float) -> None:
        self._verbs.append(V_MOVE)
        self._simple_flat += (x, y)
        self._cur = (x, y)
        self._subpath_open = True
        self._subpath_nverts = 1
        self._baked = None

    def line_to(self, x: float, y: float) -> None:
        self._verbs.append(V_LINE)
        self._simple_flat += (x, y)
        self._cur = (x, y)
        self._subpath_nverts += 1
        self._baked = None

    def cubic_to(self, c1x, c1y, c2x, c2y, x, y) -> None:
        self._verbs.append(V_CUBIC)
        self._cubic_flat += (self._cur[0], self._cur[1], c1x, c1y, c2x, c2y, x, y)
        self._cur = (x, y)
        self._subpath_nverts += 2  # lower bound; exact count resolved at bake
        self._baked = None

    def quadratic_to(self, cx, cy, x, y) -> None:
        # quad -> cubic elevation (path.cpp:195-198)
        x0, y0 = self._cur
        c1x = x0 + (2.0 / 3.0) * (cx - x0)
        c1y = y0 + (2.0 / 3.0) * (cy - y0)
        c2x = x + (2.0 / 3.0) * (cx - x)
        c2y = y + (2.0 / 3.0) * (cy - y)
        self.cubic_to(c1x, c1y, c2x, c2y, x, y)

    def arc_to(self, x1, y1, x2, y2, r) -> None:
        """Tangential-circle arc (path.cpp:203-273)."""
        x0, y0 = self._cur
        dx0, dy0 = x0 - x1, y0 - y1
        dx1, dy1 = x2 - x1, y2 - y1
        l0 = dx0 * dx0 + dy0 * dy0
        if l0 >= VG_EPSILON:
            inv = 1.0 / math.sqrt(l0)
            dx0, dy0 = dx0 * inv, dy0 * inv
        else:
            dx0, dy0 = 0.0, 0.0
        l1 = dx1 * dx1 + dy1 * dy1
        if l1 >= VG_EPSILON:
            inv = 1.0 / math.sqrt(l1)
            dx1, dy1 = dx1 * inv, dy1 * inv
        else:
            dx1, dy1 = 0.0, 0.0

        a = math.acos(max(-1.0, min(1.0, dx0 * dx1 + dy0 * dy1)))
        ta = math.tan(a / 2.0)
        d = r / ta if abs(ta) > 1e-12 else 1e9
        if d > 10000.0:
            self.line_to(x1, y1)
            return

        cross = dx1 * dy0 - dx0 * dy1
        if cross > 0.0:
            cx = x1 + dx0 * d + dy0 * r
            cy = y1 + dy0 * d - dx0 * r
            a0 = math.atan2(dx0, -dy0)
            a1 = math.atan2(-dx1, dy1)
            direction = Winding.CW
        else:
            cx = x1 + dx0 * d - dy0 * r
            cy = y1 + dy0 * d + dx0 * r
            a0 = math.atan2(-dx0, dy0)
            a1 = math.atan2(dx1, -dy1)
            direction = Winding.CCW
        self.arc(cx, cy, r, a0, a1, direction)

    def arc(self, cx, cy, r, a0, a1, direction) -> None:
        """path.cpp:633-682: normalize angles, sample a0..a1."""
        while a0 > _PI2:
            a0 -= _PI2
        while a1 > _PI2:
            a1 -= _PI2
        if direction == Winding.CCW:
            while a0 < a1:
                a0 += _PI2
        else:
            while a1 < a0:
                a1 += _PI2
        self._emit_arc(cx, cy, r, r, a0, a1, connect=True)

    def _emit_arc(self, cx, cy, rx, ry, a0, a1, connect: bool) -> None:
        """Records an ARC verb.  connect=True mirrors pathArc's lineTo/moveTo
        to the arc start (path.cpp:663-667); the bake emits the start point as
        part of the verb."""
        if not (self._subpath_open and self._subpath_nverts > 0):
            self._subpath_open = True
            self._subpath_nverts = 0
            self._verbs.append(V_MOVE)
            self._simple_flat += (cx + rx * math.cos(a0), cy + ry * math.sin(a0))
            self._subpath_nverts = 1
        else:
            self._verbs.append(V_LINE)
            self._simple_flat += (cx + rx * math.cos(a0), cy + ry * math.sin(a0))
            self._subpath_nverts += 1
        self._verbs.append(V_ARC)
        self._arc_flat += (cx, cy, rx, ry, a0, a1)
        self._cur = (cx + rx * math.cos(a1), cy + ry * math.sin(a1))
        self._subpath_nverts += 2
        self._baked = None

    def rect(self, x, y, w, h) -> None:
        if abs(w) < VG_EPSILON or abs(h) < VG_EPSILON:
            return
        self.move_to(x, y)
        self.line_to(x, y + h)
        self.line_to(x + w, y + h)
        self.line_to(x + w, y)
        self.close()

    def rounded_rect(self, x, y, w, h, r) -> None:
        if r < 0.1:
            self.rect(x, y, w, h)
            return
        max_r = min(abs(w), abs(h)) * 0.5
        if w == h and r >= max_r - VG_EPSILON:
            self.circle(x + max_r, y + max_r, max_r)
            return
        self.rounded_rect_varying(x, y, w, h, r, r, r, r)

    def rounded_rect_varying(self, x, y, w, h, rtl, rtr, rbr, rbl) -> None:
        """path.cpp:411-559: per-corner quarter arcs, clockwise from top-left,
        going down the left edge first (y-down screen convention)."""
        if rtl < 0.1 and rbl < 0.1 and rbr < 0.1 and rtr < 0.1:
            self.rect(x, y, w, h)
            return
        halfw, halfh = w * 0.5, h * 0.5
        rtl = min(rtl, halfw, halfh)
        rtr = min(rtr, halfw, halfh)
        rbl = min(rbl, halfw, halfh)
        rbr = min(rbr, halfw, halfh)

        pi_h = math.pi * 0.5
        # top-left corner
        if rtl < 0.1:
            self.move_to(x, y)
        else:
            self.move_to(x + rtl, y)
            self._emit_arc(x + rtl, y + rtl, rtl, rtl, -pi_h, -math.pi, connect=True)
        # bottom-left
        if rbl < 0.1:
            self.line_to(x, y + h)
        else:
            self.line_to(x, y + h - rbl)
            self._emit_arc(x + rbl, y + h - rbl, rbl, rbl, -math.pi, -1.5 * math.pi, connect=True)
        # bottom-right
        if rbr < 0.1:
            self.line_to(x + w, y + h)
        else:
            self.line_to(x + w - rbr, y + h)
            self._emit_arc(x + w - rbr, y + h - rbr, rbr, rbr, -1.5 * math.pi, -_PI2, connect=True)
        # top-right
        if rtr < 0.1:
            self.line_to(x + w, y)
        else:
            self.line_to(x + w, y + rtr)
            self._emit_arc(x + w - rtr, y + rtr, rtr, rtr, 0.0, -pi_h, connect=True)
        self.close()

    def circle(self, cx, cy, r) -> None:
        self.ellipse(cx, cy, r, r)

    def ellipse(self, cx, cy, rx, ry) -> None:
        """path.cpp:599-631: full revolution sampled clockwise (negative da)."""
        self.move_to(cx + rx, cy)
        self._verbs.append(V_ARC)
        self._arc_flat += (cx, cy, rx, ry, 0.0, -_PI2)
        self._cur = (cx + rx, cy)
        self._subpath_nverts += 3
        self._baked = None
        self.close()

    def polyline(self, coords: np.ndarray) -> None:
        coords = np.asarray(coords, dtype=np.float32).reshape(-1, 2)
        self._verbs.append(V_POLY)
        self._poly_args.append((self._poly_pool_len, len(coords)))
        self._poly_pool.append(coords)
        self._poly_pool_len += len(coords)
        if len(coords):
            self._cur = (float(coords[-1, 0]), float(coords[-1, 1]))
        self._subpath_nverts += len(coords)
        self._baked = None

    def close(self) -> None:
        self._verbs.append(V_CLOSE)
        self._baked = None

    # -- bake --------------------------------------------------------------
    def bake(self) -> tuple[np.ndarray, np.ndarray]:
        """Returns (vertices (V,2) f32, subpaths (S,3) i32 [first, count, closed]).

        The numpy body (the port's oracle).  One vectorized pass over all recorded
        verbs; the flattening math is the device-portable computation
        described in the module docstring.
        """
        if self._baked is not None:
            return self._baked

        verbs = np.array(self._verbs, dtype=np.int32)
        nverbs = len(verbs)
        if nverbs == 0:
            self._baked = (np.zeros((0, 2), np.float32), np.zeros((0, 3), np.int32))
            return self._baked

        counts = np.zeros(nverbs, dtype=np.int64)

        # --- cubics: Wang-formula counts, vectorized over all cubics
        cubic_ids = np.nonzero(verbs == V_CUBIC)[0]
        cubic_pts = None
        cubic_n = None
        if len(cubic_ids):
            cp = np.asarray(self._cubic_flat, dtype=np.float64).reshape(-1, 4, 2)
            d1 = cp[:, 0] - 2.0 * cp[:, 1] + cp[:, 2]
            d2 = cp[:, 1] - 2.0 * cp[:, 2] + cp[:, 3]
            m = np.maximum(np.hypot(d1[:, 0], d1[:, 1]), np.hypot(d2[:, 0], d2[:, 1]))
            tol_d = math.sqrt(self._tol) / max(self._scale, 1e-6)
            n = np.ceil(np.sqrt(np.maximum(3.0 * m / (4.0 * tol_d), 1.0))).astype(np.int64)
            n = np.clip(n, 1, 1024)
            counts[cubic_ids] = n
            cubic_pts, cubic_n = cp, n

        # --- arcs: angular-step counts
        arc_ids = np.nonzero(verbs == V_ARC)[0]
        arc_params = None
        arc_n = None
        if len(arc_ids):
            ap = np.asarray(self._arc_flat, dtype=np.float64).reshape(-1, 6)  # cx,cy,rx,ry,a0,a1
            avg_r = (np.abs(ap[:, 2]) + np.abs(ap[:, 3])) * 0.5
            sr = self._scale * np.maximum(avg_r, 1e-6)
            da = np.arccos(np.clip(sr / (sr + self._tol), -1.0, 1.0)) * 2.0
            n = np.maximum(2, np.ceil(np.abs(ap[:, 5] - ap[:, 4]) / da)).astype(np.int64)
            n = np.clip(n, 2, 4096)
            counts[arc_ids] = n
            arc_params, arc_n = ap, n

        simple_ids = np.nonzero((verbs == V_MOVE) | (verbs == V_LINE))[0]
        counts[simple_ids] = 1
        poly_ids = np.nonzero(verbs == V_POLY)[0]
        for k, i in enumerate(poly_ids):
            counts[i] = self._poly_args[k][1]

        offsets = np.zeros(nverbs + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        total = int(offsets[-1])
        out = np.empty((total, 2), dtype=np.float32)

        # simple verbs
        if len(simple_ids):
            pts = np.asarray(self._simple_flat, dtype=np.float32).reshape(-1, 2)
            out[offsets[simple_ids]] = pts

        # cubics: ragged uniform-t evaluation
        if len(cubic_ids):
            reps = cubic_n
            curve_of = np.repeat(np.arange(len(cubic_ids)), reps)
            local_i = np.arange(int(reps.sum()), dtype=np.int64) - np.repeat(
                np.concatenate([[0], np.cumsum(reps)[:-1]]), reps
            )
            t = (local_i + 1.0) / reps[curve_of]
            p = cubic_pts[curve_of]  # (T,4,2)
            mt = 1.0 - t
            w0 = (mt * mt * mt)[:, None]
            w1 = (3.0 * mt * mt * t)[:, None]
            w2 = (3.0 * mt * t * t)[:, None]
            w3 = (t * t * t)[:, None]
            pts = w0 * p[:, 0] + w1 * p[:, 1] + w2 * p[:, 2] + w3 * p[:, 3]
            dst = np.repeat(offsets[cubic_ids], reps) + local_i
            out[dst] = pts.astype(np.float32)

        # arcs: ragged angle sampling (excludes start point, includes endpoint)
        if len(arc_ids):
            reps = arc_n
            arc_of = np.repeat(np.arange(len(arc_ids)), reps)
            local_i = np.arange(int(reps.sum()), dtype=np.int64) - np.repeat(
                np.concatenate([[0], np.cumsum(reps)[:-1]]), reps
            )
            ap = arc_params[arc_of]
            th = ap[:, 4] + (ap[:, 5] - ap[:, 4]) * (local_i + 1.0) / reps[arc_of]
            px = ap[:, 0] + ap[:, 2] * np.cos(th)
            py = ap[:, 1] + ap[:, 3] * np.sin(th)
            dst = np.repeat(offsets[arc_ids], reps) + local_i
            out[dst, 0] = px.astype(np.float32)
            out[dst, 1] = py.astype(np.float32)

        # polylines: block copies
        for k, i in enumerate(poly_ids):
            off, cnt = self._poly_args[k]
            blk_start = 0
            for blk in self._poly_pool:
                if blk_start == off:
                    out[offsets[i] : offsets[i] + cnt] = blk
                    break
                blk_start += len(blk)

        # --- subpath table from MOVE/CLOSE structure
        sub_first: list[int] = []
        sub_count: list[int] = []
        sub_closed: list[int] = []
        cur_first = 0
        cur_open = False
        for i in range(nverbs):
            v = verbs[i]
            if v == V_MOVE:
                if cur_open and offsets[i] > cur_first:
                    sub_first.append(cur_first)
                    sub_count.append(int(offsets[i] - cur_first))
                    sub_closed.append(0)
                cur_first = int(offsets[i])
                cur_open = True
            elif v == V_CLOSE:
                if cur_open and offsets[i] > cur_first:
                    sub_first.append(cur_first)
                    sub_count.append(int(offsets[i] - cur_first))
                    sub_closed.append(1)
                    cur_open = False
                    cur_first = int(offsets[i])
            elif not cur_open:
                # verbs without a preceding moveTo implicitly open a subpath
                cur_open = True
                cur_first = int(offsets[i])
        if cur_open and total > cur_first:
            sub_first.append(cur_first)
            sub_count.append(int(total - cur_first))
            sub_closed.append(0)

        subs = np.stack(
            [
                np.array(sub_first, dtype=np.int32),
                np.array(sub_count, dtype=np.int32),
                np.array(sub_closed, dtype=np.int32),
            ],
            axis=1,
        ) if sub_first else np.zeros((0, 3), np.int32)

        self._baked = _dedupe(out, subs)
        return self._baked


# ---------------------------------------------------------------------------
# packed path programs (the byte-stream analogue of the reference's command
# list interpreter, vg.cpp:4332-4625, specialized to path verbs): verbs i32
# (N,), args f64 (N, 8).  Opcodes mirror native/vg_pathrec.c.
# ---------------------------------------------------------------------------

R_MOVE, R_LINE, R_CUBIC, R_QUAD, R_ARC, R_CLOSE, R_ARCTO = range(7)

_R_NARGS = {R_MOVE: 2, R_LINE: 2, R_CUBIC: 6, R_QUAD: 4, R_ARC: 6,
            R_CLOSE: 0, R_ARCTO: 5}


def pack_path_program(calls) -> tuple[np.ndarray, np.ndarray]:
    """[(opcode, args...)] -> (verbs i32 (N,), args f64 (N,8)) for
    PathRec.replay / replay_packed."""
    n = len(calls)
    verbs = np.zeros(n, np.int32)
    args = np.zeros((n, 8), np.float64)
    for i, c in enumerate(calls):
        verbs[i] = c[0]
        a = c[1:]
        args[i, : len(a)] = a
    return verbs, np.ascontiguousarray(args)


def replay_packed(pb, verbs, args) -> None:
    """Oracle decode of a packed program into any PathBuilder-like object
    (the C recorder's .replay does the same loop without Python dispatch;
    parity-tested in tests/test_pathrec.py)."""
    fns = (pb.move_to, pb.line_to, pb.cubic_to, pb.quadratic_to, pb.arc,
           pb.close, pb.arc_to)
    verbs = np.asarray(verbs, np.int32).tolist()
    rows = np.asarray(args, np.float64).reshape(-1, 8).tolist()   # py floats
    if len(rows) < len(verbs):
        # match the C recorder's contract exactly (it raises, zip truncates)
        raise ValueError("replay: args shorter than verbs")
    for op, a in zip(verbs, rows):
        na = _R_NARGS[op]
        if op == R_ARC:
            fns[op](a[0], a[1], a[2], a[3], a[4], int(a[5]))
        else:
            fns[op](*a[:na])


def _dedupe(verts: np.ndarray, subs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Collapse consecutive near-equal vertices within each subpath, and the
    closing last==first pair of closed subpaths (pathAddVertex/pathClose,
    path.cpp:707-784).  A closed subpath with <= 2 surviving vertices loses its
    closed flag (pathClose's early-out)."""
    if len(verts) == 0 or len(subs) == 0:
        return verts, subs
    keep = np.ones(len(verts), dtype=bool)
    d = verts[1:] - verts[:-1]
    close_pair = (d[:, 0] ** 2 + d[:, 1] ** 2) < VG_EPSILON
    keep[1:] = ~close_pair
    # subpath first vertices always survive (dedupe is within-subpath)
    keep[subs[:, 0]] = True

    new_subs = []
    new_counts = np.zeros(len(subs), dtype=np.int64)
    for si, (first, count, closed) in enumerate(subs):
        sl = keep[first : first + count]
        c = int(sl.sum())
        # closed: drop last if ~= first
        if closed and c > 1:
            idxs = np.nonzero(sl)[0]
            last_v = verts[first + idxs[-1]]
            first_v = verts[first + idxs[0]]
            dd = last_v - first_v
            if (dd[0] ** 2 + dd[1] ** 2) < VG_EPSILON:
                keep[first + idxs[-1]] = False
                c -= 1
        new_counts[si] = c
    new_first = np.concatenate([[0], np.cumsum(new_counts)[:-1]])
    for si, (first, count, closed) in enumerate(subs):
        c = int(new_counts[si])
        is_closed = int(closed) if c > 2 else 0
        new_subs.append((int(new_first[si]), c, is_closed))
    out_verts = verts[keep]
    out_subs = np.array(new_subs, dtype=np.int32).reshape(-1, 3)
    # drop empty subpaths
    out_subs = out_subs[out_subs[:, 1] > 0]
    return np.ascontiguousarray(out_verts), out_subs
