"""BENCHMARK.json against the rules the benchmark is built to, and every
file it names found by name."""

import json
import math
import re

import pytest

from asrbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = {c["name"]: c for c in BENCH["workloads"]}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["asrbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert all("/" not in w or w.startswith("asrbench/")
               for w in BENCH["command"])


def test_a_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_text(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric(m):
    allowed = {"name", "unit", "better", "source", "bound", "layer",
               "moves", "workloads"}
    assert set(m) <= allowed
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert set(m.get("workloads", CELLS)) <= set(CELLS)
    # every metric has a reader
    assert harness.reader(m["name"]).read


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_what_its_cells_report(m):
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    assert m["workloads"]
    for cell in m["workloads"]:
        assert cell in e2e[m["moves"]].get("workloads", CELLS)
    if "_roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_a_layer_name_is_used_letter_for_letter():
    layers = {}
    for m in BENCH["per_layer"]:
        base = m["name"].split(".")[0]
        layers.setdefault(base, set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    reported = [m for m in BENCH["end_to_end"]
                if cell["name"] in m.get("workloads", CELLS)]
    assert "setup_s" in [m["name"] for m in reported]
    assert len(reported) >= 2
    assert any(cell["name"] in m["workloads"] for m in BENCH["per_layer"])
    # its files, found by name
    assert (harness.HERE / "traffic" / f"{cell['traffic']}.json").exists()
    assert (harness.HERE / "configs" / f"{cell['config']}.py").exists()
    limits = harness.load_json(harness.HERE / "limits"
                               / f"{cell['name']}.json")
    assert all(math.isfinite(v) and v >= 0 for v in limits.values())


def test_pairs_are_unique_and_configs_used():
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith("asrbench/")
    data = harness.load_json(harness.ROOT / cfg["file"])
    assert data["name"] == cfg["name"]
    assert sorted(data["reduced"]) == sorted(cfg["reduced"])
    assert len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(("_dim", "_rank", "_size")) \
            or key == "vocab_size"
        assert key in data["assumed"]
