"""finalize_ms: ctx.profiler's `finalize` stage (the deferred geometry: bake, stroke,
edges), ms per frame."""

LAYER = "geometry: Context._finalize_ops, geometry, native"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.animate"]


def read(obs):
    return obs.stage_ms("finalize")
