"""The map cell (citymap_z17.pan) on the CPU: cut by this file to a
704 x 512 region and a 480 x 270 view at dpr 1 (the published widths are
pixels, so the cut is of scale alone), run as the harness runs it, traced
and untraced; a broken frame reads not correct; the fling path; the
configuration and the cell agree with each other."""

import json
import os
import re
import time

import pytest

from vgbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "citymap_z17.pan"
NEW_METRICS = ("pan_tiles_per_frame", "pan_entries_per_frame", "pan_edges_per_frame",
               "pan_rotated_pairs_per_frame")
SEED = 2**31 + 77


def small_map_cell(region=(704, 512), view=(480, 270)):
    """(workload, config) of the map cell cut for the CPU: a smaller
    region (the same densities and widths: fewer features, not smaller
    ones) and view, one warm-up frame, two kept frames, three traced."""
    wl = harness.load_json(ROOT, "vgbench", "workloads", f"{CELL}.json")
    cfg = harness.load_json(ROOT, "vgbench", "configs", f"{wl['config']}.json")
    cfg["width"], cfg["height"] = view
    wl["params"].update(region=list(region), warmup_frames=1, check_frames=2,
                        trace_frames=3)
    return wl, cfg


def run_map(capsys, trace, wrap=None, seconds="0.3"):
    wl, cfg = small_map_cell()
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    args = harness.parse(["--workload", CELL, "--seed", str(SEED), "--seconds", seconds,
                          "--trace", str(trace)])
    rc = harness.run(args, bench, wl, cfg, ROOT, time.perf_counter(), device="cpu",
                     cpu_sync=True, wrap=wrap)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    lines = out.out.strip().splitlines()
    return json.loads(lines[-1]), out.err, lines[:-1]


@pytest.mark.parametrize("trace", [0, 1])
def test_the_map_cell_runs_correct_and_reads_its_counters(trace, capsys):
    res, err, earlier = run_map(capsys, trace)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"]["level_gap"]["limit"] == 1.0
    assert "depth_capped_tiles 0" in err
    counters = json.loads(re.search(r"program counters (\{.*\})", earlier[0]).group(1))
    for name in ("pan_tiles", "pan_entries", "pan_edges", "sample_rotated_pairs"):
        assert counters[name] > 0
    if trace:
        for name in NEW_METRICS:
            assert res["metrics"][name]["value"] > 0, name
        per = res["metrics"]
        assert per["pan_tiles_per_frame"]["value"] * 3 < per["pan_entries_per_frame"]["value"]
    else:
        assert set(res["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_map_frame_is_not_correct(fault, capsys):
    from test_vgbench_faults import Broken

    def wrap(driver):
        return Broken(driver, fault, 3.0, driver.env.background)

    res, _err, _earlier = run_map(capsys, 0, wrap=wrap)
    assert res["correct"] is False
    assert res["checks"]["level_gap"]["value"] > res["checks"]["level_gap"]["limit"]


def test_the_path_flings_decay_and_reflect_inside_the_region():
    """Views stay inside the region, x fractional and y whole; a fling
    starts between the cell's speeds and decays by its factor; the check's
    fixed frame is the first view reflected at an edge."""
    from vgbench.traffic.mappan import Flings

    wl, _cfg = small_map_cell()
    p = wl["params"]
    span = (704 - 480.0, 512 - 270.0)
    path = Flings(p, span, SEED)
    (edge,) = path.check_always()
    views = [path.view(k) for k in range(-path.warm, 400)]
    assert all(0 <= x <= span[0] and 0 <= y <= span[1] and y == int(y) for x, y in views)
    assert len({x % 1 for x, _y in views}) > 100
    speeds = [v for *_r, v in path.pos[:300]]
    lo, hi = p["fling_speed_px"]
    starts = sorted(i for i in path.fling_starts if i < 300)
    assert len(starts) > 3 and all(lo <= speeds[i - 1] <= hi for i in starts)
    assert all(abs(speeds[i] / speeds[i - 1] - p["fling_decay"]) < 1e-12
               for i in range(1, 300) if i not in starts and i + 1 not in starts)
    assert edge >= 1 and edge + path.warm in path.edges
    assert not any(i in path.edges for i in range(path.warm + 1, edge + path.warm))
    x, y = path.view(edge)
    assert min(x, span[0] - x, y, span[1] - y) < hi


def test_the_configuration_and_the_cell_agree():
    wl = harness.load_json(ROOT, "vgbench", "workloads", f"{CELL}.json")
    cfg = harness.load_json(ROOT, "vgbench", "configs", "citymap_z17.json")
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    assert wl["params"]["region"] == cfg["region"] == [2816, 2048]
    assert (cfg["width"], cfg["height"], cfg["dpr"]) == (1920, 1080, 1.0)
    assert cfg["context_config"] == {"coverage_supersample": 1, "tile_w": 128,
                                     "tile_h": 8, "device_sampling": True}
    entry = next(c for c in bench["configs"] if c["name"] == "citymap_z17")
    assert entry["reduced"] == [] and cfg["assumed"]
    from vgbench.reference.citymap import STATS

    assert cfg["city"] == STATS
    for name in NEW_METRICS:
        m = next(x for x in bench["per_layer"] if x["name"] == name)
        assert m["workloads"] == [CELL]


def test_the_regrouped_reference_draws_the_views_ops_one_by_one():
    """The map driver's reference draws a view's ops regrouped
    (mappan._regrouped): the same image and tie pixels as the ops drawn one
    by one, to float64 rounding, from a fraction of the ops."""
    import torch

    from vgbench.reference import vg as rv
    from vgbench.reference.citymap import draw_city
    from vgbench.reference.ops import translate_ops
    from vgbench.reference.raster import render
    from vgbench.scene import read_font
    from vgbench.traffic.mappan import _regrouped

    wl, cfg = small_map_cell()
    view = (cfg["width"], cfg["height"])
    r = rv.createContext(read_font(ROOT, cfg))
    rv.begin(r, 0, *view, 1.0)
    draw_city(r, SEED, *wl["params"]["region"], **cfg["city"])
    bg = tuple(cfg["background"])
    for vx, vy in ((0.0, 0.0), (113.375, 97.0)):
        ops = translate_ops(r.ops, -vx, -vy)
        grouped = _regrouped(ops, *view)
        assert 0 < len(grouped) < len(ops) / 4
        a, ties_a = render(ops, *view, r.image_map(), background=bg)
        b, ties_b = render(grouped, *view, r.image_map(), background=bg)
        assert float((a - b).abs().max()) < 1e-9
        assert torch.equal(ties_a, ties_b)
