"""BENCHMARK.json against the benchmark's contract and its own files."""

import json
import math
import os
import re

import pytest


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vgbench"]
    assert BENCH["command"] == ["python3", "vgbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units_use_only_allowed_characters():
    named = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for text in ([w["why"] for w in BENCH["workloads"] + BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]] + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_no_name_repeats():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert {"frame_ms", "frame_p95_ms", "setup_s"} <= names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_files(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    wl = json.load(open(os.path.join(ROOT, "vgbench", "workloads", f"{cell}.json")))
    assert wl["name"] == cell and wl["config"] == w["config"] and wl["chips"] == w["chips"] == 1
    assert wl["why"] == w["why"]
    assert os.path.exists(os.path.join(ROOT, "vgbench", "traffic", f"{wl['driver']}.py"))
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert cfg["file"] == f"vgbench/configs/{w['config']}.json"
    assert json.load(open(os.path.join(ROOT, cfg["file"])))["name"] == w["config"]
    assert wl["limits"]["level_gap"] > 0


def test_every_config_is_used_and_has_a_file_of_its_own():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files)) and all(f.startswith("vgbench/") for f in files)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_file_matches_and_moves_a_reported_metric(metric):
    from vgbench.harness import metric_module

    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    mod = metric_module(ROOT, metric)
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES, mod.WORKLOADS) == (
        m["layer"], m["unit"], m["source"], m["moves"], m["workloads"])
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in CELLS
        assert cell in moved.get("workloads", CELLS)


def test_one_layer_name_per_layer_and_every_cell_reports_enough():
    from vgbench.harness import cell_metrics

    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values()), by_layer
    for cell in CELLS:
        assert cell_metrics(BENCH, cell)
        e2e = [e for e in BENCH["end_to_end"] if cell in e.get("workloads", CELLS)]
        assert "setup_s" in {e["name"] for e in e2e} and len(e2e) >= 2


def test_four_chip_cells_within_the_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_a_full_check_fits_with_24_cells():
    rs = BENCH["run_seconds"]
    cells = 24
    total = (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200
    assert total <= 43200, total
    assert not math.isnan(total)
