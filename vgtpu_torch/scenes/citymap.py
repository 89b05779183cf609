"""Scene C: a zoom-17 street map of a dense city centre, drawn through the
public vg API, for the retained pan (bake once, one view a frame).

The deployment is a slippy map's baked region: the 256 px Web Mercator
tiles around a 1920x1080 viewport plus a one-tile ring, 11 x 8 tiles,
2816 x 2048 px at 0.786 m a pixel (156,543 m / 2**17 x cos 48.86 deg),
3.56 km2.  The layer order and the z17 road widths follow the
OpenStreetMap standard style (openstreetmap-carto); the font is DejaVu
Sans, the style's label font before it moved to Noto.  There is no map
data: the geometry is procedural from the seed, and every count, width
and colour below is an assumption of this scene.

Layers, bottom to top:

  1. the land background (one rectangle);
  2. landuse and parks: star-shaped polygons of 20-120 vertices;
  3. water: one river ~190 px wide crossing the region, one polygon of
     ~2,000 vertices with one or two islands as holes (EvenOdd);
  4. buildings, ~2,500 a km2, 6-14 vertices each, 15% with a courtyard
     (EvenOdd); each filled, then outlined at 0.75 px;
  5. road casings of every class, then
  6. road fills by class, minor to major (service, residential,
     tertiary, secondary, primary: fills 6 / 11 / 14 / 16 / 18 px,
     casings 2 px wider), round caps and joins;
  7. labels: each street (a grid line or a diagonal) has one name, set on
     a way of it wherever the street has run more than 150 px since its
     last label, DejaVu Sans 11 px, turned to the way's direction and kept
     upright (transformRotate + text), and horizontal place labels at 10 px.

The style curves street names along their line; this scene sets each
name straight along the chord of its way, which keeps the glyph count and
the rotation of every quad.

draw_city(ctx, seed, width, height, **stats) draws the region and returns
what it drew (counts, kilometres, vertices).  A smaller region keeps the
densities, widths and sizes: it holds fewer features, not smaller ones.

draw_hybrid(ctx, seed, width, height, **stats) draws the same city in the
satellite-hybrid style that map services serve on HiDPI screens
(devicePixelRatio 2): one 512 x 512 imagery image a z17 tile (@2x) as an
image pattern, the roads at opacity 0.7 over it, the labels in white; no
land, landuse, water or building fills.  The imagery is procedural too
(imagery(): value noise through a palette of ground colours).
"""

from __future__ import annotations

import math

import numpy as np

import vgtpu_torch as vg
from vgtpu_torch.fonts import UI_FONT

ZOOM = 17
LATITUDE = 48.86
M_PER_PX = 156543.03392804097 / 2**ZOOM * math.cos(math.radians(LATITUDE))

# densities and sizes (this scene's assumptions; the configuration file
# repeats them)
STATS = {
    "buildings_per_km2": 2500.0,
    "courtyard_share": 0.15,
    "landuse_per_km2": 16.83,
    "place_labels_per_km2": 16.83,
    "block_px": 140.0,
    "diagonals_per_km2": 0.56,
    "river_width_px": 190.0,
    "river_vertex_px": 2.8,
    "label_min_px": 150.0,
    "street_font_px": 11.0,
    "place_font_px": 10.0,
}

# classes minor to major: name, fill width, share among ways
ROAD_CLASSES = (("service", 6.0, 0.15), ("residential", 11.0, 0.45),
                ("tertiary", 14.0, 0.15), ("secondary", 16.0, 0.15),
                ("primary", 18.0, 0.10))
CASING_EXTRA_PX = 2.0
# openstreetmap-carto colours (RGB)
LAND = (242, 239, 233)
WATER = (170, 211, 223)
BUILDING = (217, 208, 201)
BUILDING_LINE = (196, 182, 171)
BUILDING_LINE_PX = 0.75
ROAD_FILL = ((255, 255, 255), (255, 255, 255), (255, 255, 255), (247, 250, 191),
             (252, 214, 164))
ROAD_CASING = ((187, 187, 187), (187, 187, 187), (143, 143, 143), (112, 125, 5),
               (160, 107, 0))
LANDUSE = ((200, 250, 204), (205, 235, 176), (224, 223, 223), (242, 218, 217),
           (255, 214, 209), (235, 219, 232), (170, 203, 175))
STREET_TEXT = (34, 34, 34)
PLACE_TEXT = (85, 85, 85)

_SYLLABLES = ("ber", "mont", "la", "vi", "gne", "cha", "ron", "del", "mar", "tin",
              "sau", "vel", "cour", "lan", "ges", "pier", "ro", "bel", "fon", "tai",
              "ri", "vo", "lette", "bois", "sar", "ma", "dou", "que", "ville", "nor")
_STREET_PREFIX = ("Impasse", "Rue", "Rue", "Avenue", "Boulevard")
_PLACE_PREFIX = ("Quartier", "Square", "Place", "Jardin", "Cour")


def region_km2(width: int, height: int) -> float:
    return width * height * M_PER_PX * M_PER_PX / 1e6


def _word(rng) -> str:
    n = int(rng.integers(2, 4))
    w = "".join(_SYLLABLES[int(i)] for i in rng.integers(0, len(_SYLLABLES), n))
    return w[0].upper() + w[1:]


def _clip_polyline(pts: np.ndarray, w: float, h: float) -> list:
    """The parts of a polyline inside [0, w] x [0, h] (Liang-Barsky per
    segment, consecutive parts joined)."""
    out, cur = [], []
    for a, b in zip(pts[:-1], pts[1:]):
        d = b - a
        t0, t1 = 0.0, 1.0
        ok = True
        for p, q in ((-d[0], a[0]), (d[0], w - a[0]), (-d[1], a[1]), (d[1], h - a[1])):
            if p == 0.0:
                if q < 0.0:
                    ok = False
                    break
                continue
            r = q / p
            if p < 0.0:
                t0 = max(t0, r)
            else:
                t1 = min(t1, r)
        if not ok or t0 >= t1:
            if len(cur) > 1:
                out.append(np.array(cur))
            cur = []
            continue
        p0, p1 = a + t0 * d, a + t1 * d
        if not cur:
            cur = [p0]
        elif t0 > 0.0:
            if len(cur) > 1:
                out.append(np.array(cur))
            cur = [p0]
        cur.append(p1)
        if t1 < 1.0:
            if len(cur) > 1:
                out.append(np.array(cur))
            cur = []
    if len(cur) > 1:
        out.append(np.array(cur))
    return out


def _length(pts: np.ndarray) -> float:
    return float(np.hypot(*np.diff(pts, axis=0).T).sum())


def _inset(q: np.ndarray, dist: float):
    """The quad q (clockwise on screen, y down) with every side moved
    inward by dist, or None where too little is left."""
    out = []
    for k in range(4):
        a, b, c = q[k - 1], q[k], q[(k + 1) % 4]
        d1, d2 = b - a, c - b
        n1 = np.array([-d1[1], d1[0]]) / np.hypot(*d1)
        n2 = np.array([-d2[1], d2[0]]) / np.hypot(*d2)
        p1, p2 = a + dist * n1, b + dist * n2
        den = d1[0] * d2[1] - d1[1] * d2[0]
        t = ((p2 - p1)[0] * d2[1] - (p2 - p1)[1] * d2[0]) / den
        out.append(p1 + t * d1)
    out = np.array(out)
    sides = np.hypot(*(np.roll(out, -1, axis=0) - out).T)
    if sides.min() < 30.0 or np.hypot(*(out[2] - out[0])) < 40.0:
        return None
    return out


def _lots(rng, inset: np.ndarray, courtyard_share: float) -> list:
    """Building footprints along the inner sides of a block: (outer ring,
    courtyard ring or None) each, 6-14 vertices on the outer ring (a front
    and a stepped back)."""
    out = []
    for k in range(4):
        a, b = inset[k], inset[(k + 1) % 4]
        L = float(np.hypot(*(b - a)))
        u = (b - a) / L
        n_in = np.array([-u[1], u[0]])
        room = 0.45 * min(np.hypot(*(inset[(k + 2) % 4] - a)),
                          np.hypot(*(inset[(k + 3) % 4] - b)))
        t = 0.0
        while t < L - 16.0:
            court = rng.uniform() < courtyard_share
            if court:
                w, d = rng.uniform(24.0, 36.0), min(rng.uniform(30.0, 40.0), room)
            else:
                w, d = rng.uniform(6.5, 13.5), min(rng.uniform(16.0, 34.0), room)
            w = min(w, L - t)
            m = int(rng.integers(2, 7))
            dk = d * rng.uniform(0.72, 1.0, m)
            court = court and w >= 24.0 and dk.min() >= 22.0
            if w >= 6.0 and d >= 8.0:
                back = []
                for j in range(m - 1, -1, -1):
                    back += [(t + w * (j + 1) / m, dk[j]), (t + w * j / m, dk[j])]
                uv = np.array([(t, 0.0), (t + w, 0.0)] + back)
                hole = None
                if court:
                    e = dk.min() - 7.0
                    h = np.array([(t + 7, 7.0), (t + 7, e), (t + w - 7, e), (t + w - 7, 7.0)])
                    hole = a + h[:, :1] * u + h[:, 1:] * n_in
                out.append((a + uv[:, :1] * u + uv[:, 1:] * n_in, hole))
            t += w + rng.uniform(0.3, 1.5)
    return out


def plan_city(seed: int, width: int = 2816, height: int = 2048, **stats) -> dict:
    """The region's features as plain arrays, deterministic from seed:
    landuse polygons, the river and its islands, buildings (outer ring and
    optional courtyard), ways by class and the labels."""
    st = dict(STATS, **stats)
    rng = np.random.default_rng(seed)
    km2 = region_km2(width, height)
    W, H = float(width), float(height)

    # --- the river: a meandering centreline across the region ---------------
    half_w = st["river_width_px"] / 2.0
    y0 = rng.uniform(0.35, 0.65) * H
    amp = rng.uniform(0.08, 0.14) * H
    per = rng.uniform(1.1, 1.6) * W
    ph = rng.uniform(0.0, 2.0 * math.pi)
    amp2, per2, ph2 = rng.uniform(10.0, 30.0), rng.uniform(0.25, 0.45) * W, rng.uniform(0.0, 6.28)

    def river_y(x):
        return (y0 + amp * np.sin(2 * math.pi * x / per + ph)
                + amp2 * np.sin(2 * math.pi * x / per2 + ph2))

    def river_dy(x):
        return (amp * 2 * math.pi / per * np.cos(2 * math.pi * x / per + ph)
                + amp2 * 2 * math.pi / per2 * np.cos(2 * math.pi * x / per2 + ph2))

    nb = max(16, int(round(W / st["river_vertex_px"])))
    xs = np.linspace(0.0, W, nb)
    cy = river_y(xs)
    t = np.stack([np.ones(nb), river_dy(xs)], axis=1)
    t /= np.hypot(t[:, 0], t[:, 1])[:, None]
    nrm = np.stack([-t[:, 1], t[:, 0]], axis=1)
    jit = np.convolve(rng.normal(0.0, 2.0, nb + 8), np.ones(9) / 9.0, mode="valid")
    left = np.stack([xs, cy], axis=1) - nrm * (half_w + jit[:nb, None])
    right = np.stack([xs, cy], axis=1) + nrm * (half_w - jit[:nb, None])
    left[:, 0] = np.clip(left[:, 0], 0.0, W)
    right[:, 0] = np.clip(right[:, 0], 0.0, W)
    river = np.concatenate([left, right[::-1]])
    islands = []
    for _ in range(int(rng.integers(1, 3))):
        ix = rng.uniform(0.2, 0.8) * W
        iy = float(river_y(np.array([ix]))[0])
        a = math.atan2(float(river_dy(np.array([ix]))[0]), 1.0)
        hl = min(rng.uniform(120.0, 220.0), 0.15 * W)
        hw = rng.uniform(25.0, 45.0)
        n = int(rng.integers(24, 41))
        ang = np.linspace(0.0, 2 * math.pi, n, endpoint=False)
        r = 1.0 + 0.08 * np.sin(3 * ang + rng.uniform(0, 6.28))
        u, v = hl * np.cos(ang) * r, hw * np.sin(ang) * r
        islands.append(np.stack([ix + u * math.cos(a) - v * math.sin(a),
                                 iy + u * math.sin(a) + v * math.cos(a)], axis=1))

    def in_water(p, pad):
        return np.abs(p[..., 1] - river_y(p[..., 0])) < half_w + pad

    # --- landuse and parks ---------------------------------------------------
    landuse = []
    for _ in range(int(round(st["landuse_per_km2"] * km2))):
        r = min(rng.uniform(40.0, 200.0), 0.45 * min(W, H))
        cx, cyy = rng.uniform(r, W - r), rng.uniform(r, H - r)
        n = int(rng.integers(20, 121))
        ang = np.sort(rng.uniform(0.0, 2 * math.pi, n))
        k = np.arange(1, 4)[:, None]
        wob = (rng.uniform(0.05, 0.12, 3)[:, None]
               * np.sin(k * ang[None, :] + rng.uniform(0, 6.28, 3)[:, None])).sum(axis=0)
        rr = r * (0.85 + wob + rng.uniform(-0.03, 0.03, n))
        landuse.append((np.stack([cx + rr * np.cos(ang), cyy + rr * np.sin(ang)], axis=1),
                        int(rng.integers(0, len(LANDUSE)))))

    # --- the street grid: jittered nodes, lines split into ways --------------
    s = st["block_px"]
    nx = int(math.ceil(W / s)) + 1
    ny = int(math.ceil(H / s)) + 1
    gx = (np.arange(nx) - 0.5 * (nx - 1)) * s + W / 2
    gy = (np.arange(ny) - 0.5 * (ny - 1)) * s + H / 2
    nodes = np.stack(np.meshgrid(gx, gy), axis=-1) + rng.uniform(-0.18, 0.18, (ny, nx, 2)) * s
    ways = []          # (class, points, street)

    def add_line(line_pts, cls, street):
        for a, b in zip(line_pts[:-1], line_pts[1:]):
            d = b - a
            off = rng.uniform(-0.04, 0.04) * s
            mid = (a + b) / 2 + np.array([-d[1], d[0]]) / max(np.hypot(*d), 1e-9) * off
            for part in _clip_polyline(np.array([a, mid, b]), W, H):
                if _length(part) > 4.0:
                    ways.append((cls, part, street))

    # each grid line is one street of one class: the rows, then the columns,
    # take the classes in their shares (largest remainder), in an order
    # drawn from the seed
    major = np.arange(1, len(ROAD_CLASSES))
    share = np.array([ROAD_CLASSES[c][2] for c in major])
    share /= share.sum()
    lines = []
    for group in ([nodes[r_] for r_ in range(ny)], [nodes[:, c_] for c_ in range(nx)]):
        want = share * len(group)
        n_cls = np.floor(want).astype(np.int64)
        n_cls[np.argsort(n_cls - want, kind="stable")[:len(group) - int(n_cls.sum())]] += 1
        lines += zip(group, rng.permutation(np.repeat(major, n_cls)).tolist())
    for street, (line, cls) in enumerate(lines):
        add_line(line, cls, street)
    n_diag = max(1, int(round(st["diagonals_per_km2"] * km2)))
    diag_lines = []
    for _ in range(n_diag):
        a = rng.uniform(math.radians(25), math.radians(65)) * (1 if rng.uniform() < 0.5 else -1)
        px, py = rng.uniform(0.3, 0.7) * W, rng.uniform(0.3, 0.7) * H
        d = np.array([math.cos(a), math.sin(a)])
        L = 2.0 * math.hypot(W, H)
        m = int(L // (2 * s))
        line = np.array([px, py]) + np.linspace(-L / 2, L / 2, m + 1)[:, None] * d
        diag_lines.append((np.array([px, py]), d))
        add_line(line, len(ROAD_CLASSES) - 1, len(lines) + len(diag_lines) - 1)

    # bridges: a way that reaches the water crosses it, or is dropped
    kept = []
    for cls, pts, street in ways:
        dy = pts[:, 1] - river_y(pts[:, 0])
        wet = np.abs(dy) < half_w + 6.0
        if not wet.any():
            kept.append((cls, pts, street))
        elif dy.min() < -half_w and dy.max() > half_w and (cls >= 3 or rng.uniform() < 0.4):
            kept.append((cls, pts, street))
    ways = kept

    # --- buildings: lots along the inner sides of every block, two rings ----
    cand = []
    for r_ in range(ny - 1):
        for c_ in range(nx - 1):
            q = np.array([nodes[r_, c_], nodes[r_, c_ + 1], nodes[r_ + 1, c_ + 1],
                          nodes[r_ + 1, c_]])
            for dist in (12.0, 50.0):
                inset = _inset(q, dist)
                if inset is None:
                    break
                cand += _lots(rng, inset, st["courtyard_share"])

    # keep the lots inside the region, off the water and off the diagonals
    ring_len = [len(ring) for ring, _hole in cand]
    pts = np.concatenate([ring for ring, _hole in cand]) if cand else np.zeros((0, 2))
    at = np.cumsum(ring_len) - ring_len
    bad = (pts[:, 0] < 1.0) | (pts[:, 1] < 1.0) | (pts[:, 0] > W - 1.0) | (pts[:, 1] > H - 1.0)
    bad |= in_water(pts, 6.0)
    for p0, d in diag_lines:
        bad |= np.abs((pts[:, 0] - p0[0]) * d[1] - (pts[:, 1] - p0[1]) * d[0]) < 14.0
    keep = np.add.reduceat(bad, at) == 0 if cand else np.zeros(0, bool)
    cand = [c for c, k in zip(cand, keep.tolist()) if k]
    n_b = min(len(cand), int(round(st["buildings_per_km2"] * km2)))
    pick = np.sort(rng.choice(len(cand), size=n_b, replace=False))
    buildings = [cand[int(i)] for i in pick]

    # --- service ways: stubs from a block side into the block ---------------
    n_major = len(ways)
    n_service = int(round(ROAD_CLASSES[0][2] / (1.0 - ROAD_CLASSES[0][2]) * n_major))
    tries = 0
    n_srv = 0
    while n_srv < n_service and tries < 20 * max(n_service, 1):
        tries += 1
        r_, c_ = int(rng.integers(0, ny - 1)), int(rng.integers(0, nx - 1))
        k = int(rng.integers(0, 4))
        q = [nodes[r_, c_], nodes[r_, c_ + 1], nodes[r_ + 1, c_ + 1], nodes[r_ + 1, c_]]
        a, b = q[k], q[(k + 1) % 4]
        u = (b - a) / np.hypot(*(b - a))
        n_in = np.array([-u[1], u[0]])
        p0 = a + (b - a) * rng.uniform(0.25, 0.75)
        p1 = p0 + n_in * rng.uniform(25.0, 60.0)
        pts = [p0, p1]
        if rng.uniform() < 0.5:
            pts.append(p1 + u * rng.uniform(-40.0, 40.0))
        pts = np.array(pts)
        if (pts[:, 0].min() < 0 or pts[:, 1].min() < 0 or pts[:, 0].max() > W
                or pts[:, 1].max() > H or in_water(pts, 6.0).any()):
            continue
        ways.append((0, pts, -1))
        n_srv += 1

    # --- labels --------------------------------------------------------------
    street_labels = []
    run, names = {}, {}
    for cls, pts, street in ways:
        if cls == 0:
            continue
        L = _length(pts)
        run[street] = run.get(street, 0.0) + L
        if run[street] <= st["label_min_px"]:
            continue
        run[street] = 0.0
        seg = np.hypot(*np.diff(pts, axis=0).T)
        cum = np.concatenate([[0.0], np.cumsum(seg)])
        i = int(np.searchsorted(cum, L / 2) - 1)
        i = min(max(i, 0), len(seg) - 1)
        f = (L / 2 - cum[i]) / max(seg[i], 1e-9)
        mid = pts[i] + f * (pts[i + 1] - pts[i])
        chord = pts[-1] - pts[0]
        ang = math.atan2(chord[1], chord[0])
        if ang > math.pi / 2:
            ang -= math.pi
        elif ang < -math.pi / 2:
            ang += math.pi
        if street not in names:
            names[street] = f"{_STREET_PREFIX[cls]} {_word(rng)}"
        street_labels.append((float(mid[0]), float(mid[1]), ang, names[street]))
    place_labels = []
    for _ in range(int(round(st["place_labels_per_km2"] * km2))):
        name = f"{_PLACE_PREFIX[int(rng.integers(0, len(_PLACE_PREFIX)))]} {_word(rng)}"
        place_labels.append((float(rng.uniform(60.0, W - 60.0)),
                             float(rng.uniform(20.0, H - 20.0)), name))

    return {"river": river, "islands": islands, "landuse": landuse,
            "buildings": buildings, "ways": ways, "street_labels": street_labels,
            "place_labels": place_labels, "km2": km2, "stats": st}


def _font(ctx):
    """The label font's handle, cached on the context."""
    handle = getattr(ctx, "_citymap_font", None)
    if handle is None:
        data = UI_FONT.read_bytes()
        handle = ctx._citymap_font = vg.createFont(ctx, "map-sans", data, len(data), 0)
    return handle


def _ring(ctx, pts) -> None:
    xy = pts.tolist()
    vg.moveTo(ctx, *xy[0])
    for x, y in xy[1:]:
        vg.lineTo(ctx, x, y)
    vg.closePath(ctx)


def _rgb(c, alpha: int = 255):
    return vg.color4ub(c[0], c[1], c[2], alpha)


def draw_city(ctx, seed: int, width: int = 2816, height: int = 2048, **stats) -> dict:
    """Draw the region on ctx (after begin) and return what was drawn."""
    city = plan_city(seed, width, height, **stats)
    st = city["stats"]
    nonzero, evenodd = vg.FillFlags.ConcaveNonZeroAA, vg.FillFlags.ConcaveEvenOddAA

    vg.beginPath(ctx)
    vg.rect(ctx, 0.0, 0.0, float(width), float(height))
    vg.fillPath(ctx, _rgb(LAND), vg.FillFlags.ConvexAA)
    for pts, kind in city["landuse"]:
        vg.beginPath(ctx)
        _ring(ctx, pts)
        vg.fillPath(ctx, _rgb(LANDUSE[kind]), nonzero)
    vg.beginPath(ctx)
    _ring(ctx, city["river"])
    for isl in city["islands"]:
        _ring(ctx, isl)
    vg.fillPath(ctx, _rgb(WATER), evenodd)

    fill, line = _rgb(BUILDING), _rgb(BUILDING_LINE)
    courtyards = 0
    for ring, hole in city["buildings"]:
        vg.beginPath(ctx)
        _ring(ctx, ring)
        if hole is not None:
            _ring(ctx, hole)
            courtyards += 1
        vg.fillPath(ctx, fill, evenodd if hole is not None else nonzero)
        vg.strokePath(ctx, line, BUILDING_LINE_PX, vg.StrokeFlags.ButtMiterAA)

    _draw_roads(ctx, city["ways"])
    glyphs = _draw_labels(ctx, city, _rgb(STREET_TEXT), _rgb(PLACE_TEXT))
    return {
        "km2": city["km2"],
        "landuse": len(city["landuse"]),
        "river_vertices": len(city["river"]) + sum(len(i) for i in city["islands"]),
        "islands": len(city["islands"]),
        "buildings": len(city["buildings"]),
        "courtyards": courtyards,
        **_way_counts(city),
        "glyphs": glyphs,
    }


def _draw_roads(ctx, ways, alpha: int = 255) -> None:
    """Road casings of every class, then the fills minor to major, at the
    alpha byte `alpha`."""
    flags = vg.StrokeFlags.RoundRoundAA
    by_class = [[pts.tolist() for c, pts, _s in ways if c == k]
                for k in range(len(ROAD_CLASSES))]
    for casing in (True, False):
        for k, (_name, width_px, _share) in enumerate(ROAD_CLASSES):
            col = _rgb(ROAD_CASING[k] if casing else ROAD_FILL[k], alpha)
            w = width_px + (CASING_EXTRA_PX if casing else 0.0)
            for xy in by_class[k]:
                vg.beginPath(ctx)
                vg.moveTo(ctx, *xy[0])
                for x, y in xy[1:]:
                    vg.lineTo(ctx, x, y)
                vg.strokePath(ctx, col, w, flags)


def _draw_labels(ctx, city: dict, street_col, place_col) -> int:
    """The street names along their ways and the place labels; returns
    the glyphs drawn."""
    st = city["stats"]
    font = _font(ctx)
    cfg = vg.makeTextConfig(ctx, font, st["street_font_px"], vg.TextAlign.MiddleCenter,
                            street_col)
    glyphs = 0
    for x, y, ang, name in city["street_labels"]:
        vg.pushState(ctx)
        vg.transformTranslate(ctx, x, y)
        vg.transformRotate(ctx, ang)
        vg.text(ctx, cfg, 0.0, 0.0, name)
        vg.popState(ctx)
        glyphs += len(name.replace(" ", ""))
    cfg = vg.makeTextConfig(ctx, font, st["place_font_px"], vg.TextAlign.MiddleCenter,
                            place_col)
    for x, y, name in city["place_labels"]:
        vg.text(ctx, cfg, x, y, name)
        glyphs += len(name.replace(" ", ""))
    return glyphs


def _way_counts(city: dict) -> dict:
    """What draw_city and draw_hybrid report of the ways and labels."""
    ways = city["ways"]
    return {
        "ways": len(ways),
        "streets": len({s for _c, _p, s in ways if s >= 0}),
        "ways_by_class": {ROAD_CLASSES[k][0]: sum(c == k for c, _p, _s in ways)
                          for k in range(len(ROAD_CLASSES))},
        "road_km": sum(_length(p) for _c, p, _s in ways) * M_PER_PX / 1e3,
        "street_labels": len(city["street_labels"]),
        "place_labels": len(city["place_labels"]),
    }


# ---------------------------------------------------------------------------
# the satellite-hybrid style at dpr 2
# ---------------------------------------------------------------------------

IMAGERY_TILE_PX = 256          # a z17 tile, logical pixels
IMAGERY_PX = 512               # its @2x imagery, texels a side
IMAGERY_FLAGS = vg.ImageFlags.Filter_Bilinear | vg.ImageFlags.Clamp_UV
# octaves of the value noise, by lattice spacing in texels (powers of two,
# coarsest first): the ground cover's patches, and the detail that
# modulates their brightness
IMAGERY_COVER_OCTAVES = (512, 256, 128, 64, 32)
IMAGERY_DETAIL_OCTAVES = (16, 8, 4, 2)
# ground colours (RGB), dark vegetation to bright pavement
IMAGERY_PALETTE = ((46, 62, 38), (72, 88, 52), (104, 108, 80), (132, 124, 104),
                   (150, 146, 138), (112, 116, 120), (176, 170, 160))
ROAD_OPACITY = 0.7
HYBRID_LABEL = (255, 255, 255)


def _upsample2(a: np.ndarray) -> np.ndarray:
    """(h, w) -> (2h, 2w): along each axis a cell splits in two, each 3/4
    the cell and 1/4 its neighbour on that side (the edge cell its own)."""
    f = np.float32
    lo = np.concatenate([a[:, :1], a[:, :-1]], axis=1)
    hi = np.concatenate([a[:, 1:], a[:, -1:]], axis=1)
    x = np.empty((a.shape[0], 2 * a.shape[1]), np.float32)
    x[:, 0::2] = f(0.75) * a + f(0.25) * lo
    x[:, 1::2] = f(0.75) * a + f(0.25) * hi
    lo = np.concatenate([x[:1], x[:-1]], axis=0)
    hi = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.float32)
    out[0::2] = f(0.75) * x + f(0.25) * lo
    out[1::2] = f(0.75) * x + f(0.25) * hi
    return out


def _value_noise(rng, h: int, w: int, spacings) -> np.ndarray:
    """(h, w) float32 in [0, 1]: a uniform random lattice at the coarsest
    spacing, halved in spacing by _upsample2 down to one texel, with a
    lattice of half the amplitude added at each later spacing listed;
    h and w are multiples of the coarsest spacing."""
    s = spacings[0]
    acc = rng.random((h // s, w // s), dtype=np.float32)
    amp = total = 1.0
    while s > 1:
        acc, s = _upsample2(acc), s // 2
        if s in spacings:
            amp *= 0.5
            acc += np.float32(amp) * rng.random(acc.shape, dtype=np.float32)
            total += amp
    return acc / np.float32(total)


def imagery(seed: int, cols: int, rows: int) -> list:
    """The region's imagery tiles, row-major, each (IMAGERY_PX, IMAGERY_PX, 4) uint8
    RGBA with alpha 255, from a generator of its own drawn from the seed:
    two value noises over the whole region, so that the tiles join; the
    ground cover picks one of 256 colours along IMAGERY_PALETTE and the
    detail one of 64 brightness steps from 0.7 to 1.3."""
    rng = np.random.default_rng([seed, 2])
    n = IMAGERY_PX
    H, W = rows * n, cols * n
    cover = _value_noise(rng, H, W, IMAGERY_COVER_OCTAVES)
    detail = _value_noise(rng, H, W, IMAGERY_DETAIL_OCTAVES)
    pal = np.asarray(IMAGERY_PALETTE, np.float64)
    ramp = np.stack([np.interp(np.arange(256) / 255.0, np.linspace(0.0, 1.0, len(pal)),
                               pal[:, ch]) for ch in range(3)], axis=1)
    lut = np.full((256, 64, 4), 255, np.uint8)
    lut[..., :3] = np.clip(np.rint(ramp[:, None, :] * (0.7 + 0.6 * np.arange(64) / 63.0)
                                   [None, :, None]), 0, 255)
    t = np.clip((cover - np.float32(0.5)) * np.float32(3.0) + np.float32(0.5), 0, 1)
    idx = np.rint(t * np.float32(255)).astype(np.intp) * 64
    idx += np.rint(detail * np.float32(63)).astype(np.intp)
    img = lut.reshape(-1, 4).view(np.uint32).reshape(-1)[idx].view(np.uint8).reshape(H, W, 4)
    return [np.ascontiguousarray(img[r * n:(r + 1) * n, c * n:(c + 1) * n])
            for r in range(rows) for c in range(cols)]


def draw_hybrid(ctx, seed: int, width: int = 2816, height: int = 2048, **stats) -> dict:
    """The satellite-hybrid style of the same city (plan_city from the
    seed) on ctx (after begin): one imagery image a z17 tile, IMAGERY_PX
    texels a side (@2x), filled as an IMAGERY_TILE_PX logical rect with its
    image pattern at the tile's origin, without antialiasing, as a map
    client rasterises raster tiles (each pixel shows one tile); then the
    road casings and fills at ROAD_OPACITY, then the labels in
    HYBRID_LABEL, without halo.  No land, landuse, water or building
    fills: the imagery (imagery() from the seed) shows them.  The context
    needs max_images and max_image_patterns of at least the tile count."""
    city = plan_city(seed, width, height, **stats)
    cols, rows = -(-width // IMAGERY_TILE_PX), -(-height // IMAGERY_TILE_PX)
    tiles = imagery(seed, cols, rows)
    size = float(IMAGERY_TILE_PX)
    for k, data in enumerate(tiles):
        x, y = (k % cols) * size, (k // cols) * size
        img = vg.createImage(ctx, data.shape[1], data.shape[0], IMAGERY_FLAGS, data)
        pat = vg.createImagePattern(ctx, x, y, size, size, 0.0, img)
        if not vg.isValid(pat):
            raise ValueError(f"imagery tile {k}: no image or pattern left (the context "
                             f"holds {ctx.cfg.max_images} images and "
                             f"{ctx.cfg.max_image_patterns} patterns)")
        vg.beginPath(ctx)
        vg.rect(ctx, x, y, size, size)
        vg.fillPath(ctx, pat, vg.Colors.White, vg.FillFlags.Convex)
    _draw_roads(ctx, city["ways"], int(ROAD_OPACITY * 255 + 0.5))
    label = _rgb(HYBRID_LABEL)
    glyphs = _draw_labels(ctx, city, label, label)
    return {"km2": city["km2"], "imagery_tiles": len(tiles), **_way_counts(city),
            "glyphs": glyphs}
