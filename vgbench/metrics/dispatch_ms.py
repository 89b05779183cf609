"""dispatch_ms: ctx.profiler's `device_dispatch` stage: the host's time to enqueue the
frame's device work (not device time), ms per frame."""

LAYER = "launch route: Context._maybe_dispatch, ops/*_cuda.py, utils.cuda_build"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.animate"]


def read(obs):
    return obs.stage_ms("device_dispatch")
