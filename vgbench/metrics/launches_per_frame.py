"""launches_per_frame: Device operations (kernels, copies, fills) in the traced window per
frame."""

LAYER = "launch route: Context._maybe_dispatch, ops/*_cuda.py, utils.cuda_build"
UNIT = "launches/frame"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.animate",
             "tiger_ui_1080p.scroll",
             "tiger_ui_1080p_ss2.scroll"]


def read(obs):
    t = obs.trace
    return None if t is None or not t.device else len(t.device) / t.frames
