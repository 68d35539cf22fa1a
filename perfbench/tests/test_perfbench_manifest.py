"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys():
    assert list(MANIFEST) == ["command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert MANIFEST["paths"] == ["perfbench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for word in MANIFEST["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word


def test_names_and_units():
    names = ([c["name"] for c in MANIFEST["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    for name in names + [w["traffic"] for w in MANIFEST["workloads"]]:
        assert NAME.match(name), name
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in MANIFEST["per_layer"]:
        assert LINE.match(m["layer"])
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16


def test_per_layer_workloads_report_what_they_move():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        cells = e2e[m["moves"]].get("workloads", CELLS)
        for cell in m["workloads"]:
            assert cell in CELLS and cell in cells, (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(cell):
    spec = harness.cell_spec(cell, MANIFEST)
    names = [m["name"] for m in spec.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert spec.per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_files_found_by_name(cell):
    spec = harness.cell_spec(cell, MANIFEST)
    loop = harness.loop(spec.traffic["loop"])
    for part in ("window", "check", "control"):
        assert callable(getattr(loop, part))
    for key in ("entry", "traced_entry", "hook"):
        if key in spec.traffic:
            assert callable(harness.program_function(spec.traffic[key]))
    assert set(spec.limits) >= {"json_bad", "remap_off", "error_gap"}
    for m in spec.end_to_end + spec.per_layer:
        assert callable(harness.reader(m["name"]))


def test_configs_are_files_under_paths():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("perfbench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
