"""The translated cached-list layer in vgtpu_torch
(api/command_list._layer_submit, raster/retained.PendingPanLayer) against
vgtpu on the CPU.

Each case runs a vgtpu test's own body over both packages
(tests/torch_mirror.py).  Over the port, the body holds the port's layer
frames to the port with layer_memo=False at vgtpu's tolerance (3e-4, 3e-3
for text), checks the counters vgtpu's test checks, and shows the host-replay
fallbacks (a fractional vertical pan, a changed scale).  Against vgtpu's
run, every frame must bin the same FramePlans bit for bit (the suffix, the
transparent overlay bake), move the same counters (layer_cl_hits,
layer_cl_bakes, layer_bakes, memo_paint_hits, ...) and give an image within
2e-6 (vgtpu pans through its XLA formulation on the CPU, the port through
its chunk-gather twins).  The cases are the 11 tests of
tests/test_layer_cl.py and the cached-list case of tests/test_retained.py,
and renderFrames over a pending layer."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores
torch.set_num_threads(1)

from tests.torch_mirror import load, mirror, run_both  # noqa: E402

LAYER_CL_TESTS = [
    "test_translated_cached_list_matches_direct",
    "test_fractional_vertical_pan_falls_back",
    "test_scale_change_invalidates_scene",
    "test_paint_memo_composes_with_pending_layer",
    "test_background_change_with_pending_layer",
    "test_translated_list_dpr2",
    "test_text_in_translated_list",
    "test_translated_list_supersampled",
    "test_text_in_translated_list_supersampled",
    "test_static_ui_overlay_layer_over_pan",
    "test_background_change_with_overlay_layer",
]


@pytest.mark.parametrize("name", LAYER_CL_TESTS)
def test_layer_cl_matches_vgtpu(name):
    mirror("test_layer_cl", name)


def test_cached_replay_default_scissor_pans_as_vgtpu():
    mirror("test_retained", "test_cached_replay_default_scissor_pans")



def test_render_frames_materializes_the_pending_layer():
    """end(dispatch=False) + renderFrames over a translated cached-list
    frame (vgtpu's renderFrames materializes the PendingPanLayer's tiles):
    in both packages, the same frames as the fused dispatch, with the
    layer taken."""
    def run(vg):
        ns = load("test_layer_cl", vg)
        ctx, cl = ns["_make"](True)
        ref, ref_cl = ns["_make"](True)
        for k, off in enumerate(ns["OFFSETS"]):
            want = ns["_frame"](ref, ref_cl, off, 0.3 * k)
            vg.begin(ctx, 0, ns["W"], ns["H"], 1.0)
            vg.pushState(ctx)
            vg.transformTranslate(ctx, *off)
            vg.submitCommandList(ctx, cl)
            vg.popState(ctx)
            ns["_ui"](ctx, 0.3 * k)
            assert vg.end(ctx, background=ns["BG"], dispatch=False) is None
            (img,) = vg.renderFrames([ctx])
            np.testing.assert_array_equal(np.asarray(img), want, err_msg=str(off))
        assert ctx.profiler.counters.get("layer_cl_hits", 0) >= 2

    run_both(run, what="renderFrames over the pan layer")
