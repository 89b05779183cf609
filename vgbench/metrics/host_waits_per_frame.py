"""host_waits_per_frame: Host-side waits (a stream, device or event synchronise, a synchronous
copy, a scalar read back) in the traced window's CPU trace per frame,
leaving out the harness's own end-of-frame wait."""

LAYER = "upload: raster.frame.plan_to_device, raster.resolve"
UNIT = "waits/frame"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.animate"]


def read(obs):
    t = obs.trace
    return None if t is None else t.host_waits() / t.frames
