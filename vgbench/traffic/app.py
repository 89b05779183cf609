"""Traffic `app`: bench.py's app pattern (bench.py:311-325), the reference
renderer's own intended use (vg.cpp:4287-4300).  The tiger is recorded
once in a Cacheable command list and submitted at its fixed transform
each frame; the demo UI is drawn over it at t = t0 + k * ui_dt, t0 from
the seed.  Warm-up frames are k = -warmup_frames .. -1 (the list's cache,
the layer memo's bake and its settle)."""

from __future__ import annotations

from vgbench.scene import draw_program, record_reference, tiger_at


class App:
    def __init__(self, env):
        from vgtpu_torch.scenes.tiger import draw_tiger

        self.env = env
        vg = env.vg
        self.t0 = float(env.rng.uniform(0.0, 6.283185307179586))
        self.ctx = env.create_context()
        self.profiler = self.ctx.profiler
        self.cl = vg.createCommandList(self.ctx, vg.CommandListFlags.Cacheable)
        vg.beginCommandList(self.ctx, self.cl)
        draw_tiger(self.ctx, *tiger_at(env.config))
        vg.endCommandList(self.ctx)

    def warmup_frames(self):
        return range(-int(self.env.params["warmup_frames"]), 0)

    def check_always(self):
        return ()

    def frame(self, k: int, span):
        env, vg, ctx = self.env, self.env.vg, self.ctx
        cfg = env.config
        with span("record"):
            vg.begin(ctx, 0, cfg["width"], cfg["height"], cfg["dpr"])
            vg.submitCommandList(ctx, self.cl)
            draw_program(env, ctx, None, self.t0 + k * env.params["ui_dt"],
                         tiger_drawn=False)
        with span("end"):
            return vg.end(ctx, background=env.background)

    def reference(self, k: int):
        r = record_reference(self.env, tiger_at(self.env.config),
                             self.t0 + k * self.env.params["ui_dt"], from_list=True)
        return r.ops, r.fb_width, r.fb_height, r.image_map()

    def close(self) -> None:
        self.ctx = self.cl = self.profiler = None


def make(env) -> App:
    return App(env)
