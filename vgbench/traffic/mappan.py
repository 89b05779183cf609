"""Traffic `mappan`: a map region baked once, then dragged and flung, one
view a frame, as a slippy-map user pans (vgtpu_torch.scenes.citymap).

Set-up draws the configuration's city over params["region"] from the
seed (scenes/citymap.draw_city) and bakes it as a RetainedScene.  Frame k
is one view of the configuration's width and height.  The view moves in
flings: each has a direction uniform on the circle and a starting speed
uniform in params["fling_speed_px"] (pixels a frame), the speed decays by
params["fling_decay"] a frame, and a new fling starts once it falls below
params["fling_stop_px"].  The view reflects at the region's edges; x is
fractional, y whole pixels (ss = 1).  A generator of its own, drawn from
the seed, gives the start and the flings; warm-up frames are the path's
first params["warmup_frames"] views.  The reference renders the
reference's recording of the same city translated by the view, as the
scroll driver does, with the view's ops regrouped (_regrouped) into the
same image from fewer ops."""

from __future__ import annotations

import copy
import math
import sys
import time

import numpy as np

from vgbench.reference.ops import K_DRAW, P_GRADIENT, P_SOLID


class Flings:
    """The views of a run: drag-and-fling over a span of (x, y) origins,
    from a generator of its own; index i = k + warm for frame k."""

    def __init__(self, params: dict, span: tuple, seed: int) -> None:
        self.p, self.span = params, span
        self.warm = int(params["warmup_frames"])
        self.rng = np.random.default_rng([seed, 1])
        self.fling_starts, self.edges = set(), set()
        x = float(self.rng.uniform(0.0, span[0]))
        y = float(self.rng.uniform(0.0, span[1]))
        self.pos = [(x, y) + self._fling()]

    def _fling(self) -> tuple:
        lo, hi = self.p["fling_speed_px"]
        a = float(self.rng.uniform(0.0, 2 * math.pi))
        return math.cos(a), math.sin(a), float(self.rng.uniform(lo, hi))

    def _step(self) -> None:
        """The next view: the fling moves on, reflects at an edge, decays,
        and a new one starts once it is slow."""
        i = len(self.pos)
        x, y, dx, dy, v = self.pos[-1]
        x, y = x + v * dx, y + v * dy
        if x < 0.0 or x > self.span[0]:
            x, dx = (-x if x < 0.0 else 2 * self.span[0] - x), -dx
            self.edges.add(i)
        if y < 0.0 or y > self.span[1]:
            y, dy = (-y if y < 0.0 else 2 * self.span[1] - y), -dy
            self.edges.add(i)
        v *= float(self.p["fling_decay"])
        if v < float(self.p["fling_stop_px"]):
            dx, dy, v = self._fling()
            self.fling_starts.add(i + 1)
        self.pos.append((x, y, dx, dy, v))

    def at(self, i: int) -> tuple:
        while len(self.pos) <= i:
            self._step()
        return self.pos[i]

    def view(self, k: int) -> tuple:
        """(x, y) of frame k: x fractional, y a whole pixel."""
        x, y = self.at(k + self.warm)[:2]
        return x, float(min(max(round(y), 0), int(self.span[1])))

    def check_always(self) -> list:
        """The first view reflected at a region edge, where the path folds
        back and the view shows the region's border.  (The check's
        reference draws a map view in ~4-5 s on the card and records the
        city once in ~5.5 s, so a run keeps this view and the window's
        first, no more: a traced run then ends ~45 s after its window.)"""
        i = self.warm + 1
        self.at(i)
        while i not in self.edges and i < self.warm + 100000:
            i += 1
            self.at(i)
        return [i - self.warm]


class MapPan:
    def __init__(self, env):
        from vgtpu_torch.raster.retained import RetainedScene
        from vgtpu_torch.scenes.citymap import draw_city

        self.env = env
        p, cfg, vg = env.params, env.config, env.vg
        self.region = [int(v) for v in p["region"]]
        fb_w, fb_h = round(cfg["width"] * cfg["dpr"]), round(cfg["height"] * cfg["dpr"])
        span = (float(self.region[0] - fb_w), float(self.region[1] - fb_h))
        if min(span) <= 0:
            raise ValueError("the region must be larger than the view")
        self.path = Flings(p, span, env.seed)
        t0 = time.perf_counter()
        self.ctx = env.create_context()
        vg.begin(self.ctx, 0, cfg["width"], cfg["height"], cfg["dpr"])
        self.drawn = draw_city(self.ctx, env.seed, *self.region, **cfg["city"])
        t1 = time.perf_counter()
        self.scene = RetainedScene.bake(self.ctx, *self.region, background=env.background)
        plan = self.scene.plan
        depth = max((int((te >= 0).sum(axis=1).max()) for te, _i, _f in plan.tile_buckets),
                    default=0)
        print(f"mappan: drew {len(self.ctx.ops)} ops in {t1 - t0:.3f} s, baked in "
              f"{time.perf_counter() - t1:.3f} s: {plan.n_real_entries} entries, "
              f"deepest tile {depth}, depth_capped_tiles "
              f"{plan.stats.get('depth_capped_tiles', 0)}; {self.drawn}",
              file=sys.stderr, flush=True)
        self.profiler = self.ctx.profiler
        self._ref = None

    # -- the driver ----------------------------------------------------------
    def warmup_frames(self):
        return range(-self.path.warm, 0)

    def check_always(self):
        return self.path.check_always()

    def frame(self, k: int, span):
        vx, vy = self.path.view(k)
        with span("render"):
            return self.scene.render(vx, vy)

    def reference(self, k: int):
        from vgbench.reference import vg as rv
        from vgbench.reference.citymap import draw_city
        from vgbench.reference.ops import translate_ops

        if self._ref is None:
            env, cfg = self.env, self.env.config
            r = rv.createContext(env.font_data)
            rv.begin(r, 0, cfg["width"], cfg["height"], cfg["dpr"])
            draw_city(r, env.seed, *self.region, **cfg["city"])
            self._ref = r, _boxes(r.ops)
        r, boxes = self._ref
        vx, vy = self.path.view(k)
        # the ops whose box meets the view (with a margin): the rasterizer
        # draws nothing of the others in this frame
        m = 4.0
        near = ((boxes[:, 2] >= vx - m) & (boxes[:, 0] <= vx + r.fb_width + m)
                & (boxes[:, 3] >= vy - m) & (boxes[:, 1] <= vy + r.fb_height + m))
        ops = translate_ops([op for op, keep in zip(r.ops, near.tolist()) if keep], -vx, -vy)
        return _regrouped(ops, r.fb_width, r.fb_height), r.fb_width, r.fb_height, r.image_map()

    def close(self) -> None:
        self.ctx = self.scene = self.profiler = None


def _boxes(ops) -> np.ndarray:
    """(N, 4) x0, y0, x1, y1 of each op's edges or textured quads; an op
    with neither (a clip commit or reset) spans everything."""
    out = np.empty((len(ops), 4))
    for i, op in enumerate(ops):
        if op.tex_quads is not None and len(op.tex_quads):
            q = np.asarray(op.tex_quads, np.float64)
            xs = np.concatenate([q[:, 0], q[:, 0] + q[:, 2], q[:, 0] + q[:, 4],
                                 q[:, 0] + q[:, 2] + q[:, 4]])
            ys = np.concatenate([q[:, 1], q[:, 1] + q[:, 3], q[:, 1] + q[:, 5],
                                 q[:, 1] + q[:, 3] + q[:, 5]])
            out[i] = xs.min(), ys.min(), xs.max(), ys.max()
        elif op.edges is not None and len(op.edges):
            e = np.asarray(op.edges, np.float64)
            out[i] = e[:, [0, 2]].min(), e[:, [1, 3]].min(), e[:, [0, 2]].max(), e[:, [1, 3]].max()
        else:
            out[i] = -np.inf, -np.inf, np.inf, np.inf
    return out


def _regrouped(ops, width: int, height: int) -> list:
    """The ops of a view regrouped, so that the reference rasterizer draws
    fewer, larger ops and the image it draws from the ops one by one.

    The rasterizer draws an op inside the op's pixel box alone, so two ops
    whose boxes are disjoint commute, and two such ops of one paint, fill
    rule, antialiased, are one op of both edge lists: at a pixel of one
    box the other's closed contours add a winding of zero.  Each op takes
    a level one above the highest level drawn anywhere in its box (grown
    by 2 px, clipped to the view); ops of one level have disjoint boxes, so
    the levels are drawn in order, and at each level one op per paint
    (textured quads, triangle lists and aliased or control ops stay
    alone).  A map view's ~8,000 ops become ~470, which the rasterizer,
    paced by its cost per op, draws in a third of the time on an H100."""
    b = _boxes(ops)
    x0 = np.clip(np.floor(b[:, 0]) - 2, 0, width).astype(np.int64)
    y0 = np.clip(np.floor(b[:, 1]) - 2, 0, height).astype(np.int64)
    x1 = np.clip(np.ceil(b[:, 2]) + 3, 0, width).astype(np.int64)
    y1 = np.clip(np.ceil(b[:, 3]) + 3, 0, height).astype(np.int64)
    level = np.full((height, width), -1, np.int64)
    groups: dict = {}
    for i, op in enumerate(ops):
        if x1[i] <= x0[i] or y1[i] <= y0[i]:
            continue                # nothing of it in the view
        box = level[y0[i]:y1[i], x0[i]:x1[i]]
        lv = int(box.max()) + 1
        box[...] = lv
        if (op.kind == K_DRAW and op.aa and op.paint_kind in (P_SOLID, P_GRADIENT)
                and op.tri_paints is None and op.edges is not None and len(op.edges)):
            key = (lv, op.fill_rule, op.paint_kind, op.image_id, op.scissor,
                   np.asarray(op.paint, np.float32).tobytes())
        else:
            key = (lv, i)
        groups.setdefault(key, []).append(op)
    out = []
    for key in sorted(groups, key=lambda k: k[0]):   # stable: first op's order
        group = groups[key]
        op = group[0]
        if len(group) > 1:
            op = copy.copy(op)
            op.edges = np.concatenate([np.asarray(o.edges, np.float32) for o in group])
        out.append(op)
    return out


def make(env) -> MapPan:
    return MapPan(env)
