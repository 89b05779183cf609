"""The run command on the card: each cell once, short, traced and not
(-m card: python3 -m pytest vgbench/tests -m card on a machine with the
card)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_of_the_cell_is_correct(cell, trace, card):
    out = subprocess.run([sys.executable, "vgbench/run.py", "--workload", cell,
                          "--seed", str(2**31 + 21), "--seconds", "2", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, out.stderr[-3000:]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert res["device"]["busy_s"] > 0 and res["breakdown"]["device_ops"]
