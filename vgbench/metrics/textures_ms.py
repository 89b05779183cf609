"""textures_ms: ctx.profiler's `textures` stage (colour tiles of glyph quads and
patterns), ms per frame."""

LAYER = "textures: Context._fill_textures, ops.sampling_device"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.animate"]


def read(obs):
    return obs.stage_ms("textures")
