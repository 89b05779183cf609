"""A cell added as files only: a copy of the benchmark gets a new workload
file (an existing driver with other parameters) and its BENCHMARK.json
entry, and the harness runs it without an edit to any file it had."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUN = r"""
import json, sys, time
sys.path.insert(0, COPY)
sys.path.insert(1, TESTS)
from conftest import _small_cell
from vgbench import harness
assert harness.__file__.startswith(COPY)
bench = harness.load_json(COPY, "BENCHMARK.json")
wl, cfg = _small_cell("tiger_ui_1080p.scroll_fast")
args = harness.parse(["--workload", "tiger_ui_1080p.scroll_fast", "--seed", "5",
                      "--seconds", "0.3", "--trace", "1"])
sys.exit(harness.run(args, bench, wl, cfg, COPY, time.perf_counter(), device="cpu",
                     cpu_sync=True))
"""


def digest(d):
    h = {}
    for dp, _dn, fs in os.walk(d):
        for f in fs:
            p = os.path.join(dp, f)
            h[os.path.relpath(p, d)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return h


def test_a_new_cell_is_files_only(tmp_path):
    copy = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "vgbench"), os.path.join(copy, "vgbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    os.symlink(os.path.join(ROOT, "vgtpu_torch"), os.path.join(copy, "vgtpu_torch"))
    before = digest(os.path.join(copy, "vgbench"))

    # the new cell: a data file and its manifest entry
    wl = json.load(open(os.path.join(copy, "vgbench", "workloads", "tiger_ui_1080p.scroll.json")))
    wl["name"] = "tiger_ui_1080p.scroll_fast"
    wl["params"]["step_px"] = [11.5, 5.0]
    wl["why"] = "the pan at a faster scroll"
    with open(os.path.join(copy, "vgbench", "workloads", "tiger_ui_1080p.scroll_fast.json"), "w") as f:
        json.dump(wl, f)
    bench = json.load(open(os.path.join(copy, "BENCHMARK.json")))
    bench["workloads"].append({"name": wl["name"], "config": wl["config"],
                               "traffic": "scroll_fast", "chips": 1, "why": wl["why"]})
    for m in bench["per_layer"]:
        if "tiger_ui_1080p.scroll" in m["workloads"]:
            m["workloads"].append(wl["name"])
    with open(os.path.join(copy, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    code = RUN.replace("COPY", repr(copy)).replace("TESTS", repr(os.path.join(copy, "vgbench", "tests")))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=copy, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert "render_host_ms" in res["metrics"]

    after = digest(os.path.join(copy, "vgbench"))
    changed = {k for k in before if after.get(k) != before[k]}
    assert not changed and set(after) - set(before) == {"workloads/tiger_ui_1080p.scroll_fast.json"}

    # the real command finds the cell by name and stops at the look for a card
    out = subprocess.run([sys.executable, "vgbench/run.py", "--workload", wl["name"],
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=copy, env=env, timeout=600)
    import torch

    if not torch.cuda.is_available():
        assert out.returncode == 1 and "CUDA device" in out.stderr and not out.stdout.strip()
