"""BENCHMARK.json: its names and units, and every configuration, mix and
per-layer metric resolving to a file of its own."""

import json
import re
from pathlib import Path

import pytest

from sigebench.layers import reader

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= B["run_seconds"] <= 51
    assert B["paths"] == ["sigebench"]


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[group]:
            yield group, e["name"]
    for w in B["workloads"]:
        yield "config", w["config"]
        yield "traffic", w["traffic"]
    for c in B["configs"]:
        for k in c["reduced"]:
            yield "reduced", k


@pytest.mark.parametrize("group,name", list(_names()))
def test_names(group, name):
    assert NAME.match(name), (group, name)


@pytest.mark.parametrize("m", B["end_to_end"] + B["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_units_and_keys(m):
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "bound" in m:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in B["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert callable(reader(m["name"]))
    cells = {w["name"] for w in B["workloads"]}
    assert set(m.get("workloads", [])) <= cells


def test_unique_names_and_files():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in B[group]]
        assert len(names) == len(set(names))
    files = [c["file"] for c in B["configs"]]
    assert len(files) == len(set(files))
    for c in B["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "sigebench/")
    for w in B["workloads"]:
        assert (ROOT / "sigebench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200


def test_every_cell_reports_setup_and_another_end_to_end_metric():
    e2e = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for w in B["workloads"]:
        layers = [m for m in B["per_layer"]
                  if w["name"] in m.get("workloads", [w["name"]])]
        assert layers


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_moves_a_metric_its_cells_report(m):
    e2e = {e["name"]: e for e in B["end_to_end"]}
    cells = [w["name"] for w in B["workloads"]]
    moved = e2e[m["moves"]]
    for cell in m.get("workloads", cells):
        assert cell in moved.get("workloads", cells), (m["name"], cell)
