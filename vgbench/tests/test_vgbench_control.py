"""The control of `correct`: the reference in the program's place with a
bfloat16 composite (control.py) has to fail the check.  On the CPU at dpr
0.25 here; at the cell's own size on three seeds on the card (-m card)."""

import json
import os

import pytest

from vgbench import harness, readings

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


def limit(cell):
    return harness.load_json(ROOT, "vgbench", "workloads", f"{cell}.json")["limits"]["level_gap"]


@pytest.mark.parametrize("cell", ["tiger_ui_1080p.animate", "tiger_ui_1080p_ss2.scroll"])
def test_the_control_fails_on_the_cpu(cell, small_cell):
    wl, cfg = small_cell(cell)
    rows = readings.readings(cell, [], [2**31 + 3], 0.3, device="cpu", cpu=True,
                             config=cfg, params=wl["params"], out=open(os.devnull, "w"))
    assert rows[0]["level_gap"] > limit(cell)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(cell, card, capsys):
    rows = readings.readings(cell, [], [11, 2**31 + 12, 13], 2.0, device=card)
    for r in rows:
        assert r["level_gap"] > limit(cell), json.dumps(r)
