"""render_host_ms: The benchmark's host clock from the call to RetainedScene.render to its
return (before the device finishes), ms per frame."""

LAYER = "retained pan: raster.retained.RetainedScene.render"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.scroll",
             "tiger_ui_1080p_ss2.scroll"]


def read(obs):
    return obs.span_ms("render")
