"""bin_native_ms: ctx.profiler's `bin.native` stage: the native binner's
calls (vg_bin_frame) inside the `bin` stage, ms per frame."""

LAYER = "binner: raster.binning, native vg_bin_frame"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.animate"]


def read(obs):
    return obs.stage_ms("bin.native")
