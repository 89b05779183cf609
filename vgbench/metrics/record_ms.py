"""record_ms: The benchmark's host clock around each frame's begin and draw calls (and
submitCommandList), in ms per frame of the untimed window's frames."""

LAYER = "recorder: api.context begin and draw calls, scenes"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.animate"]


def read(obs):
    return obs.span_ms("record")
