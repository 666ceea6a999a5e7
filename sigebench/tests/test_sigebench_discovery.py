"""Cells are data: a traffic file dropped into ``sigebench/traffic`` and
an entry in ``BENCHMARK.json`` make a new cell, with no other file
edited."""

import json
import shutil
from pathlib import Path

from sigebench.harness import load_cell
from sigebench.layers import reader

ROOT = Path(__file__).resolve().parents[2]


def test_a_new_traffic_file_is_found_by_name(tmp_path):
    shutil.copytree(ROOT / "sigebench" / "configs",
                    tmp_path / "sigebench" / "configs")
    (tmp_path / "sigebench" / "traffic").mkdir()
    mix = json.loads((ROOT / "sigebench/traffic/window_s8.json").read_text())
    mix.update(sessions=16, period=5, stagger=1)
    (tmp_path / "sigebench/traffic/window_s16_fast.json").write_text(
        json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "ddpm_church256.window_s16_fast", "config": "ddpm_church256",
        "traffic": "window_s16_fast", "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("ddpm_church256.window_s16_fast", root=tmp_path)
    assert cell.mix["sessions"] == 16
    assert cell.config["family"] == "ddpm"


def test_every_layer_reader_found_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        quantity = m["name"].split(".")[0]  # a split name reads its quantity
        assert (ROOT / "sigebench" / "layers" / f"{quantity}.py").is_file()
        assert callable(reader(m["name"]))
