"""pan_rotated_pairs_per_frame: ctx.profiler's `sample_rotated_pairs` counter:
the (entry, glyph quad) pairs of non-separable sampling groups (rotated
labels: the exact gather) that one resample pass, one S1 launch on the card,
samples, per frame.
Each view's resample (ops/sampling_device.sample_tiles_flat) adds the
count of the tile index built at bake; no cell but the map's hands the
harness the scene's profiler, so it reads nothing elsewhere."""

LAYER = "retained pan: raster.retained.RetainedScene.render"
UNIT = "pairs/frame"
SOURCE = "program_counter"
MOVES = "frame_ms"
WORKLOADS = ["citymap_z17.pan"]


def read(obs):
    n = obs.counters.get("sample_rotated_pairs")
    return None if n is None else n / obs.frames
