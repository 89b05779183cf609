"""The check catches a broken timed path: each run below skips the
harness's look for a card and drives the rest of a run on the CPU (the
cell at dpr 0.25), with the program's frames broken underneath, and
`correct` has to come out false.  The faults a frame can have: a step
that returns its state unchanged (the previous frame again), half of the
frame left out (its lower half never drawn), and an answer altered where
it is produced (one tile's red channel off by a few levels).  The
exchange between chips has no counterpart: every cell runs on one card."""

import json
import os
import re
import time

import pytest

from vgbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ["tiger_ui_1080p.animate", "tiger_ui_1080p.scroll", "tiger_ui_1080p_ss2.app",
         "tiger_ui_1080p_ss2.scroll"]


class Broken:
    def __init__(self, driver, fault, levels, background):
        self.driver, self.fault, self.levels, self.bg = driver, fault, levels, background
        self.profiler = driver.profiler
        self.prev = None

    def warmup_frames(self):
        return self.driver.warmup_frames()

    def check_always(self):
        return self.driver.check_always()

    def frame(self, k, span):
        img = self.driver.frame(k, span)
        if self.fault == "unchanged":
            out, self.prev = (self.prev if self.prev is not None else img), img.clone()
            return out
        img = img.clone()
        if self.fault == "half":
            img[img.shape[0] // 2:] = img.new_tensor(self.bg)
        else:
            img[0:8, 0:128, 0] += self.levels / 255.0
        return img

    def reference(self, k):
        return self.driver.reference(k)

    def close(self):
        self.driver.close()


def run_cell(cell, small_cell, capsys, wrap=None, seed=2**31 + 77):
    wl, cfg = small_cell(cell)
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    args = harness.parse(["--workload", cell, "--seed", str(seed), "--seconds", "0.3",
                          "--trace", "0"])
    rc = harness.run(args, bench, wl, cfg, ROOT, time.perf_counter(), device="cpu",
                     cpu_sync=True, wrap=wrap)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    lines = out.out.strip().splitlines()
    return json.loads(lines[-1]), out.err, wl, lines[:-1]


@pytest.mark.parametrize("cell", CELLS)
def test_an_unbroken_run_is_correct(cell, small_cell, capsys):
    res, err, wl, earlier = run_cell(cell, small_cell, capsys)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    hits = dict(re.findall(r"(memo_hits|layer_hits|layer_cl_hits) (\d+)", " ".join(earlier)))
    if cell.endswith(".animate"):
        assert hits["memo_hits"] == hits["layer_hits"] == "0"    # the full host path
    if cell.endswith(".app"):
        assert int(hits["layer_hits"]) + int(hits["layer_cl_hits"]) > 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["level_gap"]["limit"] == wl["limits"]["level_gap"]
    assert err.strip().splitlines()[-1].startswith("check level_gap ")


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_frame_is_not_correct(cell, fault, small_cell, capsys):
    wl, _cfg = small_cell(cell)
    levels = max(3.0, 2.0 * wl["limits"]["level_gap"])

    def wrap(driver):
        return Broken(driver, fault, levels, driver.env.background)

    res, _err, _wl, _earlier = run_cell(cell, small_cell, capsys, wrap=wrap)
    assert res["correct"] is False
    assert res["checks"]["level_gap"]["value"] > res["checks"]["level_gap"]["limit"]
