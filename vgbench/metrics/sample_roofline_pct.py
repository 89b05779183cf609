"""sample_roofline_pct: the texture sampler's share of its roofline: 100 x
a frozen byte bound over the device ms a frame of kernel S1 (its symbol
sample_tiles_kernel, as sample_device_ms reads it).

The bound is the least any implementation of the view's sampling needs:
each physical pixel of the 3840 x 2160 view (the configuration's 1920 x
1080 at devicePixelRatio 2) reads its texel once and writes its colour
once, 4 bytes each as RGBA8, over the HBM rate of one H100 SXM
(roofline.PEAK_BYTES, 3.35 TB/s): 66,355,200 bytes, 0.0198 ms.  It leaves
out the glyph quads, so it is a floor whatever implements the sampling."""

LAYER = "textures: Context._fill_textures, ops.sampling_device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["citymap_z17_hybrid2x.pan"]

SYMBOL = "sample_tiles_kernel"
VIEW_PX = 3840 * 2160
BOUND_BYTES = VIEW_PX * (4 + 4)


def read(obs):
    from vgbench.roofline import bound_ms

    t = obs.trace
    if t is None or not any(SYMBOL in n for n, _a, _b in t.device):
        return None
    return 100.0 * bound_ms(BOUND_BYTES, 0.0) / t.device_ms_by(lambda name: SYMBOL in name)
