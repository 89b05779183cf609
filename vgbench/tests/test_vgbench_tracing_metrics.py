"""The readers of the program's own spans and counters: record_text_ms,
bin_native_ms, upload_copies_per_frame, pan_resample_launches_per_frame and
pan_resample_idle_ms, on a hand-built traced window and observation, each
against its value computed by hand, and None where the program has nothing
to read (a program without the spans); then a traced run of each cell on
the CPU at a small size reports the metrics its cell lists."""

import json
import os
import time

import pytest

from vgbench import harness
from vgbench.trace import Trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NEW = ("record_text_ms", "bin_native_ms", "upload_copies_per_frame",
       "pan_resample_launches_per_frame", "pan_resample_idle_ms")


def read(name, obs):
    return harness.metric_module(ROOT, name).read(obs)


def obs_of(trace=None, stages=None, counters=None, frames=10):
    return harness.Observation("cell", frames, {}, stages or {}, counters or {},
                               trace, lambda: [])


def window():
    """Two frames over [0, 1000] us.  Busy [100, 300] and [600, 700]; the
    resample ranges [50, 250], [500, 800] and [950, 1100] (clipped to
    1000), a vg.pan around them and launches inside and outside."""
    device = [("k1", 100.0, 200.0), ("k2", 150.0, 300.0), ("k3", 600.0, 700.0)]
    host = [
        ("vgbench.frame", 0.0, 500.0), ("vgbench.frame", 500.0, 1000.0),
        ("vg.pan", 40.0, 1000.0),
        ("vg.pan.resample", 50.0, 250.0), ("vg.pan.resample", 500.0, 800.0),
        ("vg.pan.resample", 950.0, 1100.0),
        ("cudaLaunchKernel", 10.0, 20.0),       # before the first range
        ("cudaLaunchKernel", 60.0, 65.0),       # inside
        ("aten::add", 70.0, 80.0),              # not a launch
        ("cudaMemcpyAsync", 120.0, 130.0),      # inside
        ("cuLaunchKernel", 260.0, 270.0),       # between ranges
        ("cudaMemsetAsync", 510.0, 512.0),      # inside
        ("cudaLaunchKernel", 799.0, 805.0),     # starts inside
        ("cudaLaunchKernel", 800.0, 805.0),     # starts at the range's end
        ("cudaLaunchKernelExC", 990.0, 995.0),  # inside the clipped range
    ]
    return Trace(2, device, host, 0.0, 1000.0)


def test_pan_resample_launches_per_frame_counts_launches_starting_inside():
    # 60, 120, 510, 799, 990: five over two frames
    assert read("pan_resample_launches_per_frame", obs_of(window())) == 2.5


def test_pan_resample_idle_ms_is_the_idle_time_inside_the_ranges():
    # idle [0,100] [300,600] [700,1000]; inside the ranges: [50,100] 50,
    # [500,600] 100, [700,800] 100, [950,1000] 50 -> 300 us over two frames
    assert read("pan_resample_idle_ms", obs_of(window())) == pytest.approx(0.15)


def test_pan_resample_readers_with_ranges_and_no_launch_or_idle():
    t = Trace(1, [("k", 0.0, 100.0)], [("vg.pan.resample", 10.0, 90.0)], 0.0, 100.0)
    assert read("pan_resample_launches_per_frame", obs_of(t)) == 0.0
    assert read("pan_resample_idle_ms", obs_of(t)) == 0.0


@pytest.mark.parametrize("name", ["pan_resample_launches_per_frame",
                                  "pan_resample_idle_ms"])
def test_pan_resample_readers_give_none_without_the_program_ranges(name):
    assert read(name, obs_of(None)) is None
    bare = window()
    bare.host = [h for h in bare.host if not h[0].startswith("vg.")]
    assert read(name, obs_of(bare)) is None
    outside = Trace(1, [], [("vg.pan.resample", 2000.0, 2100.0)], 0.0, 1000.0)
    assert read(name, obs_of(outside)) is None


def test_stage_and_counter_readers():
    obs = obs_of(stages={"record.text": 30.0, "bin": 20.0, "bin.native": 12.0},
                 counters={"upload_copies": 421}, frames=10)
    assert read("record_text_ms", obs) == 3.0
    assert read("bin_native_ms", obs) == 1.2
    assert read("upload_copies_per_frame", obs) == 42.1


@pytest.mark.parametrize("name", ["record_text_ms", "bin_native_ms",
                                  "upload_copies_per_frame"])
def test_stage_and_counter_readers_give_none_without_the_program_stage(name):
    parent = obs_of(stages={"bin": 20.0, "finalize": 5.0, "upload": 9.0},
                    counters={"upload_bytes": 1 << 20, "memo_hits": 0})
    assert read(name, parent) is None


@pytest.mark.parametrize("cell", ["tiger_ui_1080p.animate", "tiger_ui_1080p.scroll"])
def test_a_traced_cpu_run_reports_the_new_metrics_of_its_cell(cell, small_cell, capsys):
    """The program on the CPU at dpr 0.25: the stage and counter metrics in
    animate; in scroll the resample ranges are there (no launches on the
    CPU, and every microsecond of them idle: no device ops)."""
    wl, cfg = small_cell(cell)
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    args = harness.parse(["--workload", cell, "--seed", str(2**31 + 19),
                          "--seconds", "0.3", "--trace", "1"])
    rc = harness.run(args, bench, wl, cfg, ROOT, time.perf_counter(), device="cpu",
                     cpu_sync=True)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    res = json.loads(out.out.strip().splitlines()[-1])
    listed = {m["name"] for m in harness.cell_metrics(bench, cell)} & set(NEW)
    assert listed and listed <= set(res["metrics"]), (listed, res["metrics"])
    m = {k: v["value"] for k, v in res["metrics"].items()}
    if cell.endswith("animate"):
        assert 0 < m["record_text_ms"] <= m["record_ms"]
        assert 0 < m["bin_native_ms"] <= m["bin_ms"]
        assert m["upload_copies_per_frame"] > 10
    else:
        assert m["pan_resample_launches_per_frame"] == 0.0
        assert m["pan_resample_idle_ms"] > 0
