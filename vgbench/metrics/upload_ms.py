"""upload_ms: ctx.profiler's `upload` stage (plan_to_device, the resolve split), ms
per frame."""

LAYER = "upload: raster.frame.plan_to_device, raster.resolve"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.animate"]


def read(obs):
    return obs.stage_ms("upload")
