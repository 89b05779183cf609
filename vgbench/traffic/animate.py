"""Traffic `animate`: the tiger under a smooth transform that changes every
frame, the demo UI live over it, each frame recorded and ended in full.

Frame k: the tiger scaled about its centre by 1 + scale_span *
sin(a + pi/3) and moved by shift_px * (sin(a), sin(2a)), a = 2 pi (k + k0)
/ period_frames, one closed path of period_frames poses; the UI at t = t0
+ k * ui_dt.  The seed draws only where on the path a run starts (k0) and
t0, so every seed runs the same poses in another order.  Warm-up frames
are k = -warmup_frames .. -1 on the same path."""

from __future__ import annotations

import math

from vgbench.scene import draw_program, record_reference, tiger_at


class Animate:
    def __init__(self, env):
        self.env = env
        p = env.params
        rng = env.rng
        self.period = int(p["period_frames"])
        self.k0 = int(rng.integers(0, self.period))
        self.t0 = float(rng.uniform(0.0, 2 * math.pi))
        self.ctx = env.create_context()
        self.profiler = self.ctx.profiler

    def pose(self, k: int):
        p = self.env.params
        a = 2 * math.pi * (k + self.k0) / self.period
        tiger = tiger_at(self.env.config, 1.0 + p["scale_span"] * math.sin(a + math.pi / 3),
                         p["shift_px"] * math.sin(a), p["shift_px"] * math.sin(2 * a))
        return tiger, self.t0 + k * p["ui_dt"]

    def warmup_frames(self):
        return range(-int(self.env.params["warmup_frames"]), 0)

    def check_always(self):
        return ()

    def frame(self, k: int, span):
        env, vg, ctx = self.env, self.env.vg, self.ctx
        tiger, t = self.pose(k)
        cfg = env.config
        with span("record"):
            vg.begin(ctx, 0, cfg["width"], cfg["height"], cfg["dpr"])
            draw_program(env, ctx, tiger, t)
        with span("end"):
            return vg.end(ctx, background=env.background)

    def reference(self, k: int):
        r = record_reference(self.env, *self.pose(k))
        return r.ops, r.fb_width, r.fb_height, r.image_map()

    def close(self) -> None:
        self.ctx = self.profiler = None


def make(env) -> Animate:
    return Animate(env)
