"""Traffic `hybridpan`: the satellite-hybrid city map at the configuration's
devicePixelRatio, baked once, then dragged and flung, one view a frame
(vgtpu_torch.scenes.citymap.draw_hybrid).

Set-up draws the hybrid style of the configuration's city over
params["region"] (logical pixels), its imagery made once from the seed
(scenes/citymap.imagery), and bakes it as a RetainedScene over the
region's physical pixels (region x dpr).  Frame k
is one view of width x dpr by height x dpr physical pixels.  The views
move as the map cell's do (mappan.Flings), in physical pixels: each fling
has a direction uniform on the circle and a starting speed uniform in
params["fling_speed_px"] a frame, decays by params["fling_decay"] a frame,
and a new one starts below params["fling_stop_px"]; the view reflects at
the region's edges, x fractional, y whole pixels.  The check holds the
window's first view and its first view at a region edge.  The reference
records the reference's hybrid of the same city with the reference's copy
of the imagery generator, and draws each view as the map driver does:
the ops near the view, translated by it and regrouped (mappan._regrouped)."""

from __future__ import annotations

import sys
import time

from vgbench.traffic.mappan import Flings, _boxes, _regrouped


class HybridPan:
    def __init__(self, env):
        from vgtpu_torch.raster.retained import RetainedScene
        from vgtpu_torch.scenes.citymap import draw_hybrid

        self.env = env
        p, cfg, vg = env.params, env.config, env.vg
        self.region = [int(v) for v in p["region"]]
        dpr = float(cfg["dpr"])
        phys = [round(v * dpr) for v in self.region]
        fb_w, fb_h = round(cfg["width"] * dpr), round(cfg["height"] * dpr)
        span = (float(phys[0] - fb_w), float(phys[1] - fb_h))
        if min(span) <= 0:
            raise ValueError("the region must be larger than the view")
        self.path = Flings(p, span, env.seed)
        self.ctx = env.create_context()
        vg.begin(self.ctx, 0, cfg["width"], cfg["height"], dpr)
        t1 = time.perf_counter()
        self.drawn = draw_hybrid(self.ctx, env.seed, *self.region, **cfg["city"])
        t2 = time.perf_counter()
        self.scene = RetainedScene.bake(self.ctx, *phys, background=env.background)
        t3 = time.perf_counter()
        plan, prof = self.scene.plan, self.ctx.profiler
        depth = max((int((te >= 0).sum(axis=1).max()) for te, _i, _f in plan.tile_buckets),
                    default=0)
        samp = self.scene.d.get("samp")
        print(f"hybridpan: drew the imagery and {len(self.ctx.ops)} ops in "
              f"{t2 - t1:.3f} s, baked in {t3 - t2:.3f} s (bake.textures "
              f"{prof.times_ms.get('bake.textures', 0.0) / 1e3:.3f} s): "
              f"{plan.n_real_entries} entries, deepest tile {depth}, colour tiles "
              f"{0 if samp is None else samp.num_tiles}, pattern tiles "
              f"{0 if samp is None else samp.pattern_tiles}, texture_bytes "
              f"{prof.counters.get('texture_bytes', 0)}, depth_capped_tiles "
              f"{plan.stats.get('depth_capped_tiles', 0)}; {self.drawn}",
              file=sys.stderr, flush=True)
        self.profiler = prof
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
        from vgbench.reference.citymap_hybrid import draw_hybrid
        from vgbench.reference.ops import translate_ops

        if self._ref is None:
            env, cfg = self.env, self.env.config
            r = rv.createContext(env.font_data)
            rv.begin(r, 0, cfg["width"], cfg["height"], cfg["dpr"])
            draw_hybrid(r, env.seed, *self.region, **cfg["city"])
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


def make(env) -> HybridPan:
    return HybridPan(env)
