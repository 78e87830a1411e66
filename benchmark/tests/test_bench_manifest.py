"""The manifest and the files it names: found by name, and inside the
limits that the benchmark's contract sets."""

import json
import os
import re

import pytest

from benchmark.harness import main as harness
from benchmark.harness import manifest

BENCH = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = manifest.cell(cell)
    wl = manifest.workload(cell)
    cfg = manifest.config(entry["config"])
    assert cfg["name"] == entry["config"]
    assert manifest.driver(wl["driver"]).run
    flops = manifest.flops(entry["config"])
    assert flops.forward_flops(64, 64) > 0
    assert wl["why"] == entry["why"] and len(entry["why"]) <= 200
    assert set(wl["limits"]) >= {"batch_mismatch"} or \
        set(wl["limits"]) == {"mask_gap"}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(manifest.reader(metric).read)


@pytest.mark.parametrize("entry", METRICS + BENCH["workloads"]
                         + BENCH["configs"], ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]


def test_config_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(manifest.ROOT, c["file"]))
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_bounds():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names and len(names) <= 5
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports(cell):
    e2e = [m["name"] for m in manifest.metrics_of(cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = manifest.metrics_of(cell, "per_layer")
    assert layer and all(m["moves"] in e2e for m in layer)


def test_four_chip_cells():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert manifest.workload(w["name"]).get("ranks", 1) == w["chips"]


def test_forbidden_names_compared_whole(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "fabric_tpu_torch_probe",
                        types.ModuleType("fabric_tpu_torch_probe"))
    assert "fabric_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fabric_tpu.probe",
                        types.ModuleType("fabric_tpu.probe"))
    assert "fabric_tpu" in harness.forbidden_modules()
