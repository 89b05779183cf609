"""upload_copies_per_frame: ctx.profiler's `upload_copies` counter: the
host-to-device copies the upload issues (one per host array the plan puts
on the card), per frame."""

LAYER = "upload: raster.frame.plan_to_device, raster.resolve"
UNIT = "copies/frame"
SOURCE = "program_counter"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.animate"]


def read(obs):
    n = obs.counters.get("upload_copies")
    return None if n is None else n / obs.frames
