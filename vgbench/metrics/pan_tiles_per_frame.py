"""pan_tiles_per_frame: ctx.profiler's `pan_tiles` counter: the scene tiles
kernel K2 writes a view (the real rows of the baked tile buckets), per
frame.
RetainedScene.render adds the bake's constant each view; no cell but the
map's hands the harness the scene's profiler, so it reads nothing
elsewhere."""

LAYER = "retained pan: raster.retained.RetainedScene.render"
UNIT = "tiles/frame"
SOURCE = "program_counter"
MOVES = "frame_ms"
WORKLOADS = ["citymap_z17.pan"]


def read(obs):
    n = obs.counters.get("pan_tiles")
    return None if n is None else n / obs.frames
