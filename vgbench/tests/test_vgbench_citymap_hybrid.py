"""The hybrid map cell (citymap_z17_hybrid2x.pan) on the CPU: cut by this
file to a 768 x 512 logical region (3 x 2 imagery tiles) and a 320 x 180
logical view at dpr 2 (the published widths and texel sizes kept, so the
cut is of scale alone), run as the harness runs it, traced and untraced;
a broken frame reads not correct; the configuration and the cell agree
with each other and with the scene."""

import json
import os
import re
import time

import pytest

from vgbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "citymap_z17_hybrid2x.pan"
NEW_METRICS = ("sample_pattern_tiles_per_frame", "sample_device_ms", "sample_roofline_pct")
SEED = 2**31 + 77


def small_hybrid_cell(region=(768, 512), view=(320, 180)):
    """(workload, config) of the hybrid cell cut for the CPU: a smaller
    region and view at the same dpr, one warm-up frame, two kept frames,
    three traced."""
    wl = harness.load_json(ROOT, "vgbench", "workloads", f"{CELL}.json")
    cfg = harness.load_json(ROOT, "vgbench", "configs", f"{wl['config']}.json")
    cfg["width"], cfg["height"] = view
    wl["params"].update(region=list(region), warmup_frames=1, check_frames=2,
                        trace_frames=3)
    return wl, cfg


def run_hybrid(capsys, trace, wrap=None, seconds="0.3"):
    wl, cfg = small_hybrid_cell()
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
def test_the_hybrid_cell_runs_correct_and_reads_its_counters(trace, capsys):
    """Correct, with the set-up line's pattern tiles and texture bytes; the
    traced run reads the pattern tiles a frame (S1's two device metrics
    read nothing on the CPU, where no kernel runs)."""
    res, err, earlier = run_hybrid(capsys, trace)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"]["level_gap"]["limit"] == 1.0
    setup = re.search(r"pattern tiles (\d+), texture_bytes (\d+)", err)
    assert setup and int(setup.group(1)) > 6 * 4 * 64 and int(setup.group(2)) > 6 * 2**22
    counters = json.loads(re.search(r"program counters (\{.*\})", earlier[0]).group(1))
    frames = res["attempted"]
    assert counters["sample_pattern_tiles"] == int(setup.group(1)) * frames
    if trace:
        per = res["metrics"]
        assert per["sample_pattern_tiles_per_frame"]["value"] == int(setup.group(1))
        assert "sample_device_ms" not in per and "sample_roofline_pct" not in per
    else:
        assert set(res["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_hybrid_frame_is_not_correct(fault, capsys):
    from test_vgbench_faults import Broken

    def wrap(driver):
        return Broken(driver, fault, 3.0, driver.env.background)

    res, _err, _earlier = run_hybrid(capsys, 0, wrap=wrap)
    assert res["correct"] is False
    assert res["checks"]["level_gap"]["value"] > res["checks"]["level_gap"]["limit"]


def test_the_sampler_metrics_read_s1_from_the_trace():
    """sample_device_ms sums the device ops named after S1's symbol per
    traced frame; sample_roofline_pct is 100 x the frozen 66.4 MB bound at
    3.35 TB/s (0.0198 ms) over it; both read nothing without S1."""
    from vgbench.trace import Trace

    dev = harness.metric_module(ROOT, "sample_device_ms")
    roof = harness.metric_module(ROOT, "sample_roofline_pct")
    ops = [("void sample_tiles_kernel(int const*, ...)", 0.0, 150.0),
           ("composite_bucket_kernel", 150.0, 400.0),
           ("void sample_tiles_kernel(int const*, ...)", 1000.0, 1100.0)]
    obs = harness.Observation(CELL, 2, {}, {}, {}, Trace(2, ops, [], 0.0, 2000.0), list)
    assert dev.read(obs) == pytest.approx(0.125)
    assert roof.BOUND_BYTES == 66_355_200
    assert roof.read(obs) == pytest.approx(100 * 66_355_200 / 3.35e12 * 1e3 / 0.125)
    none = harness.Observation(CELL, 2, {}, {}, {}, Trace(2, ops[1:2], [], 0.0, 2000.0), list)
    assert dev.read(none) is None and roof.read(none) is None


def test_the_configuration_and_the_cell_agree():
    wl = harness.load_json(ROOT, "vgbench", "workloads", f"{CELL}.json")
    cfg = harness.load_json(ROOT, "vgbench", "configs", "citymap_z17_hybrid2x.json")
    city = harness.load_json(ROOT, "vgbench", "configs", "citymap_z17.json")
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    assert wl["params"]["region"] == cfg["region"] == city["region"] == [2816, 2048]
    assert cfg["region_physical"] == [2 * v for v in cfg["region"]]
    assert (cfg["width"], cfg["height"], cfg["dpr"]) == (1920, 1080, 2.0)
    assert {k: v for k, v in cfg["context_config"].items()
            if not k.startswith("max_")} == city["context_config"]
    assert min(cfg["context_config"]["max_images"],
               cfg["context_config"]["max_image_patterns"]) >= cfg["imagery"]["count"] == 88
    assert cfg["city"] == city["city"] and cfg["font"] == city["font"]
    assert wl["params"]["fling_speed_px"] == [2 * v for v in
                                              harness.load_json(ROOT, "vgbench", "workloads",
                                                                "citymap_z17.pan.json")
                                              ["params"]["fling_speed_px"]]
    entry = next(c for c in bench["configs"] if c["name"] == "citymap_z17_hybrid2x")
    assert entry["reduced"] == [] and cfg["assumed"]
    from vgbench.reference import citymap_hybrid as ref

    assert cfg["road_opacity"] == ref.ROAD_OPACITY
    assert tuple(cfg["label_rgb"]) == ref.HYBRID_LABEL
    assert [tuple(c) for c in cfg["imagery"]["palette"]] == list(ref.IMAGERY_PALETTE)
    assert cfg["imagery"]["grid"] == [2816 // ref.IMAGERY_TILE_PX, 2048 // ref.IMAGERY_TILE_PX]
    assert cfg["imagery"]["size_px"] == [ref.IMAGERY_PX] * 2
    for name in NEW_METRICS:
        m = next(x for x in bench["per_layer"] if x["name"] == name)
        assert m["workloads"] == [CELL]
