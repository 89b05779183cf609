"""sample_footprint_px_per_frame: ctx.profiler's `sample_footprint_px`
counter: the (pair, pixel) slots inside S1's footprints, the pixels of each
(entry, quad) pair's colour tile that the resample samples it at, per frame.
Each view's resample (ops/sampling_device.sample_tiles_flat) adds the
count taken at no shift from the tile index built at bake; no cell but the
map's hands the harness the scene's profiler, and a program without the
counter reads nothing."""

LAYER = "retained pan: raster.retained.RetainedScene.render"
UNIT = "slots/frame"
SOURCE = "program_counter"
MOVES = "frame_ms"
WORKLOADS = ["citymap_z17.pan"]


def read(obs):
    n = obs.counters.get("sample_footprint_px")
    return None if n is None else n / obs.frames
