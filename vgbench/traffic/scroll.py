"""Traffic `scroll`: the frame baked once as a RetainedScene over the
scene size in set-up, then one view of the configuration's width and
height a frame (examples/retained_pan.py's use: bake once, scroll).

The view moves by step_px = (dx, dy) a frame and bounces inside the
scene: x fractional, y on whole sub-rows (multiples of 1/ss pixels).  The
seed draws the start (x fractional, y on the sub-row grid) and the two
directions, so every seed runs the same views in another order.  The
reference renders the recorded frame translated by the view, not the
baked scene."""

from __future__ import annotations

import math

from vgbench.scene import draw_program, record_reference, tiger_at


def _bounce(u, span):
    """The triangle wave of period 2 * span over [0, span]."""
    u = u % (2 * span)
    return u if u <= span else 2 * span - u


class Scroll:
    def __init__(self, env):
        from vgtpu_torch.raster.retained import RetainedScene

        self.env = env
        p, cfg, vg = env.params, env.config, env.vg
        self.ss = env.ss
        fb_w, fb_h = round(cfg["width"] * cfg["dpr"]), round(cfg["height"] * cfg["dpr"])
        self.span_x = p["scene"][0] - fb_w                            # pixels
        self.span_y = (p["scene"][1] - fb_h) * self.ss                # sub-rows
        rng = env.rng
        self.x0 = float(rng.uniform(0.0, 2 * self.span_x))
        self.y0 = int(rng.integers(0, 2 * self.span_y))
        self.sx, self.sy = (1 if s else -1 for s in rng.integers(0, 2, size=2))
        self.step_y = round(p["step_px"][1] * self.ss)
        if abs(self.step_y - p["step_px"][1] * self.ss) > 1e-9:
            raise ValueError("step_px[1] must be a whole number of sub-rows")
        self.ctx = env.create_context()
        vg.begin(self.ctx, 0, cfg["width"], cfg["height"], cfg["dpr"])
        draw_program(env, self.ctx, tiger_at(cfg), p["ui_t"])
        self.scene = RetainedScene.bake(self.ctx, *p["scene"], background=env.background)
        self.profiler = None
        self._ref = None

    def view(self, k: int):
        x = _bounce(self.x0 + self.sx * k * self.env.params["step_px"][0], self.span_x)
        y = _bounce(self.y0 + self.sy * k * self.step_y, self.span_y)
        return x, y / self.ss

    def warmup_frames(self):
        return range(-int(self.env.params["warmup_frames"]), 0)

    def check_always(self):
        """The window's second view (at ss=2 the other sub-row parity of
        the first), and on each axis the view nearest each of its first two
        turns: the scene's two edges, where the path folds back."""
        ks = {1}
        p = self.env.params
        for u0, s, step, span in ((self.x0, self.sx, p["step_px"][0], self.span_x),
                                  (self.y0, self.sy, self.step_y, self.span_y)):
            for m in (1, 2):
                edge = (math.floor(u0 / span) + m if s > 0 else math.ceil(u0 / span) - m) * span
                ks.add(round(abs(edge - u0) / step))
        return sorted(ks)

    def frame(self, k: int, span):
        vx, vy = self.view(k)
        with span("render"):
            return self.scene.render(vx, vy)

    def reference(self, k: int):
        from vgbench.reference.ops import translate_ops

        if self._ref is None:
            self._ref = record_reference(self.env, tiger_at(self.env.config),
                                         self.env.params["ui_t"])
        r = self._ref
        vx, vy = self.view(k)
        return translate_ops(r.ops, -vx, -vy), r.fb_width, r.fb_height, r.image_map()

    def close(self) -> None:
        self.ctx = self.scene = None


def make(env) -> Scroll:
    return Scroll(env)
