"""bench.py's cached-list pan pattern (pan_diag), the one chip_smoke.py
[11] runs on the card at 1920x1080, through vgtpu_torch and vgtpu on the
CPU at dpr 0.5: the tiger in a Cacheable command list under
transformTranslate(2.5 k, 2 k), the demo UI drawn over it.  Frame by frame
both packages bin the same plans (bit for bit), give images within 2e-6
and move the same counters; after chip_smoke.PAN_APP_WARM frames the layer
counters are chip_smoke.PAN_APP_COUNTS, the numbers the card is held to.
dpr 0.5 keeps every vertical step on whole pixels (2 k logical = k device
pixels), as dpr 1 does on the card, so the same frames take the layer."""

from __future__ import annotations

import importlib

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores
torch.set_num_threads(1)

import chip_smoke as cs  # noqa: E402
from tests.torch_mirror import run_both  # noqa: E402


def test_bench_pan_pattern_counts_match_vgtpu():
    def run(vg):
        # each package draws with its own scenes
        tiger = importlib.import_module(f"{vg.__name__}.scenes.tiger")
        ui = importlib.import_module(f"{vg.__name__}.scenes.demo_ui")
        ctx = vg.createContext()
        cl = cs.tiger_list(vg, ctx, tiger.draw_tiger)
        for k in range(cs.PAN_APP_WARM):
            cs.pan_app_frame(vg, ctx, cl, ui.draw_demo_ui, k, dpr=0.5)
        c = ctx.profiler.counters
        got = {k: c.get(k, 0) for k in cs.PAN_APP_COUNTS}
        assert got == cs.PAN_APP_COUNTS, (vg.__name__, dict(c))
        assert type(ctx._layer_render).__name__ == "PendingPanLayer"
        assert ctx._layer_render.over_tiles is not None   # the overlay baked

    run_both(run, what="pan_diag")
