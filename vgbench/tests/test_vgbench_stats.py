"""The harness's end-to-end arithmetic on synthetic latencies, and the
seeded sample of frames it keeps for the check."""

import os
import statistics

import numpy as np
import pytest

from vgbench.harness import Reservoir, p95

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_p95_is_the_tail_of_every_frame_and_sees_a_stall():
    # 400 frames of 10 ms with a stall of 12 frames at 80 ms: a median of
    # chunks of 10 frames never sees it, the tail of all frames does
    lat = [0.010] * 400
    for i in range(200, 212):
        lat[i] = 0.080
    chunk_medians = [statistics.median(lat[i:i + 10]) for i in range(0, 400, 10)]
    assert max(chunk_medians) == pytest.approx(0.080) or statistics.median(chunk_medians) == 0.010
    assert statistics.median(chunk_medians) == pytest.approx(0.010)
    assert p95(lat) == pytest.approx(0.010)          # 3% of frames: under the 95th
    lat2 = list(lat)
    for i in range(300, 330):                         # now 10.5% of frames stall
        lat2[i] = 0.080
    assert p95(lat2) == pytest.approx(0.080)
    assert statistics.median(chunk_medians) < p95(lat2)


def test_p95_matches_the_inclusive_quantile():
    rng = np.random.default_rng(7)
    lat = list(rng.gamma(4.0, 0.005, size=701))
    want = statistics.quantiles(lat, n=20, method="inclusive")[18]
    assert p95(lat) == want
    assert p95([0.02]) == 0.02


def test_frame_ms_is_window_over_frames_not_a_median():
    lat = [0.010] * 90 + [0.110] * 10
    window = sum(lat)
    frame_ms = window * 1e3 / len(lat)
    assert frame_ms == pytest.approx(20.0)
    assert statistics.median(lat) * 1e3 == pytest.approx(10.0)


class _Img:
    def __init__(self, k):
        self.k = k

    def clone(self):
        return _Img(self.k)


def test_reservoir_is_seeded_uniform_and_bounded():
    def sample(seed, n_frames):
        r = Reservoir(3, np.random.default_rng([seed, 1]))
        for k in range(n_frames):
            r.offer(k, _Img(k))
        return sorted(k for k, _img in r.kept)

    assert sample(5, 1000) == sample(5, 1000)
    assert sample(5, 1000) != sample(6, 1000)
    assert sample(5, 2) == [0, 1]
    counts = np.zeros(50)
    for seed in range(2000):
        for k in sample(seed, 50):
            counts[k] += 1
    # each frame kept with probability 3/50: 120 of 2000, within 4 sigma
    assert np.all(np.abs(counts - 120) < 4 * np.sqrt(120))


def test_reservoir_keeps_its_always_frames_besides_the_sample():
    r = Reservoir(3, np.random.default_rng([9, 1]), always={0, 7, 500})
    for k in range(100):
        r.offer(k, _Img(k))
    kept = [k for k, _img in r.kept]
    assert kept[:2] == [0, 7] and len(kept) == 5 and 500 not in kept
    assert r.seen == 98 and not {0, 7} & {k for k, _img in r.sampled}


@pytest.mark.parametrize("cell", ["tiger_ui_1080p.scroll", "tiger_ui_1080p_ss2.scroll"])
def test_the_scroll_check_always_holds_the_scenes_edges(cell):
    """check_always's views reach within a step of each of the scene's
    four edges, whatever the seed draws."""
    from types import SimpleNamespace

    from vgbench import harness
    from vgbench.traffic.scroll import Scroll

    wl = harness.load_json(ROOT, "vgbench", "workloads", f"{cell}.json")
    cfg = harness.load_json(ROOT, "vgbench", "configs", f"{wl['config']}.json")
    p = wl["params"]
    for seed in (1, 2**31 + 5, 706, 4100000705):
        s = Scroll.__new__(Scroll)
        s.env = SimpleNamespace(params=p)
        s.ss = cfg["context_config"]["coverage_supersample"]
        s.span_x = p["scene"][0] - cfg["width"]
        s.span_y = (p["scene"][1] - cfg["height"]) * s.ss
        rng = np.random.default_rng(seed)
        s.x0, s.y0 = float(rng.uniform(0, 2 * s.span_x)), int(rng.integers(0, 2 * s.span_y))
        s.sx, s.sy = (1 if v else -1 for v in rng.integers(0, 2, size=2))
        s.step_y = round(p["step_px"][1] * s.ss)
        views = [s.view(k) for k in s.check_always()]
        for axis, span, step in ((0, s.span_x, p["step_px"][0]),
                                 (1, s.span_y / s.ss, p["step_px"][1])):
            assert min(v[axis] for v in views) <= step / 2 + 1e-9
            assert max(v[axis] for v in views) >= span - step / 2 - 1e-9
