"""Every file the benchmark finds by name loads, and BENCHMARK.json keeps
to its shape: its keys, names, units, lengths and references."""
import json
import re
from pathlib import Path

import pytest

from regbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["regbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    lines = [c["source"] for c in BENCH["configs"]]
    for entry in BENCH["configs"] + BENCH["workloads"] \
            + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        lines += [entry[k] for k in ("why", "layer") if k in entry]
    lines += BENCH["command"]
    for text in lines:
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text, text
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(set(METRICS)) == len(METRICS)
    assert len(set(CELLS)) == len(CELLS)


def test_cells_reference_what_exists():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for c in BENCH["workloads"]:
        assert c["config"] in configs and c["chips"] in (1, 4)
        assert (c["config"], c["traffic"]) not in pairs
        pairs.add((c["config"], c["traffic"]))
    assert sum(c["chips"] == 4 for c in BENCH["workloads"]) \
        <= max(1, len(CELLS) // 4)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_loads_and_reports(cell):
    spec = harness.load_spec(cell)
    names = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert spec.per_layer
    for m in spec.per_layer:
        assert m["moves"] in names
    assert spec.traffic["entry"] in harness.ENTRIES
    for key in ("rows_per_launch", "spacing_gap", "k2_gap", "k1_gap"):
        assert key in spec.limits


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_has_a_reader(name):
    assert callable(harness.reader(name))


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_each_config_file(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["name"] == config and data["reduced"] == entry["reduced"]
    from regbench.scenes import KINDS
    assert all(g["kind"] in KINDS for g in data["pool"])
    assert {"success_rot_deg", "success_trans", "min_recall",
            "plade_config"} <= set(data)
