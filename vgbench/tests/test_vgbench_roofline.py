"""The frozen roofline arithmetic: hand-counted shapes, and the 1080p
frame against the bounds in PERF.md's kernel table."""

import numpy as np
import pytest

from vgbench.reference.ops import RasterOp, make_solid_paint
from vgbench.roofline import PEAK_BYTES, PEAK_FLOPS, bound_ms, frame_work


def rect_op(x0, y0, x1, y1, scissor=None):
    e = np.array([[x0, y0, x0, y1], [x0, y1, x1, y1], [x1, y1, x1, y0], [x1, y0, x0, y0]],
                 np.float32)
    return RasterOp(edges=e, paint=make_solid_paint(np.ones(4, np.float32)), scissor=scissor)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert bound_ms(PEAK_BYTES, 0) == pytest.approx(1e3)
    assert bound_ms(0, PEAK_FLOPS) == pytest.approx(1e3)
    assert bound_ms(PEAK_BYTES, PEAK_FLOPS * 2) == pytest.approx(2e3)


def test_a_rectangle_counted_by_hand():
    # x in [10, 300), y in [4, 20): the vertical edges span 16 rows each and
    # cross the tile rows 0-2 (8-row tiles); the horizontal edges add nothing
    w = frame_work([rect_op(10, 4, 300, 20)], 512, 64, 1, 128, 8)
    c = w["counts"]
    assert c["live_pairs"] == 32
    assert c["pieces"] == 6                 # two edges x three tile rows
    # edge tiles: columns 0 and 2 in tile rows 0-2; column 1 has no edge
    # but the fill reaches it in all three tile rows; column 3 lies outside
    assert c["edge_entries"] == 6
    assert c["entries"] == 9
    assert c["tiles"] == 9
    assert w["coverage"] == (6 * 16 + 6 * 1024 * 4, 32 * (128 * 12 + 6))
    assert w["composite"] == (6 * 1024 * 4 + 9 * 128 + 9 * 1024 * 16, 9 * 1024 * 20)


def test_supersampling_doubles_the_live_rows_not_the_planes():
    w1 = frame_work([rect_op(10, 4, 300, 20)], 512, 64, 1, 128, 8)
    w2 = frame_work([rect_op(10, 4, 300, 20)], 512, 64, 2, 128, 8)
    assert w2["counts"]["live_pairs"] == 2 * w1["counts"]["live_pairs"]
    assert w2["composite"] == w1["composite"]


def test_a_scissor_drops_the_tiles_outside_it():
    w = frame_work([rect_op(10, 4, 300, 20, scissor=(0, 0, 128, 64))], 512, 64, 1, 128, 8)
    assert w["counts"]["entries"] == 3 and w["counts"]["edge_entries"] == 3
    assert w["counts"]["tiles"] == 3


def test_the_1080p_frame_lands_on_the_kernel_tables_bounds():
    """PERF.md's kernel table (counted on the port's chunk pools and buckets):
    K1's live bound 0.0159 ms (bytes), K2 (a)'s 0.0203 ms.  The frozen
    count over the frame's own edges and tiles lands within a fifth."""
    from vgbench.reference import demo_ui, vg
    from vgtpu_torch.fonts import UI_FONT

    r = vg.createContext(UI_FONT.read_bytes())
    vg.begin(r, 0, 1920, 1080, 1.0)
    demo_ui.draw_benchmark_frame(r, 0.0)
    w = frame_work(r.ops, 1920, 1080, 1, 128, 8)
    assert bound_ms(*w["coverage"]) == pytest.approx(0.0159, rel=0.2)
    assert bound_ms(*w["composite"]) == pytest.approx(0.0203, rel=0.2)


def test_a_static_prefix_counts_once():
    a, b, c = rect_op(10, 4, 300, 20), rect_op(0, 30, 100, 60), rect_op(0, 30, 120, 60)
    full = frame_work([a, b], 512, 64, 1, 128, 8)
    suffix = frame_work([a, c], 512, 64, 1, 128, 8, prev_ops=[a, b])
    alone = frame_work([c], 512, 64, 1, 128, 8)
    assert suffix["counts"]["static_prefix"] == 1
    assert suffix["coverage"] == alone["coverage"]
    n = alone["counts"]["tiles"] * 1024 * 16
    assert suffix["composite"] == (alone["composite"][0] + n, alone["composite"][1])
    assert frame_work([a, b], 512, 64, 1, 128, 8, prev_ops=[c])["composite"] == full["composite"]
