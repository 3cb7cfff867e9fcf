"""BENCHMARK.json against the contract it is checked by, and every file a
cell names found by name."""

import math
import os
import re

import pytest

from port_bench import manifest

BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRIC_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    assert os.path.exists(os.path.join(manifest.ROOT, BENCH["command"][1]))
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert _line(c["source"]) and _line(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= METRIC_KEYS and m["source"] in ("host_clock",
                                                         "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS - {"bound"} | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    names += CELLS + [m["name"] for m in BENCH["end_to_end"]
                      + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(CELLS)


def test_each_moves_is_reported_where_it_is_read():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in manifest.end_to_end(BENCH, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.per_layer(BENCH, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    spec, mix, config = manifest.cell_files(cell)
    assert (spec["config"], spec["traffic"], spec["chips"]) == (
        entry["config"], entry["traffic"], entry["chips"])
    assert config["name"] == entry["config"]
    assert callable(manifest.driver_class(mix["kind"]))
    for m in manifest.per_layer(BENCH, cell):
        assert callable(manifest.reader(m["name"]))
    assert spec["limits"]
    for value in spec["limits"].values():
        assert value is not None and math.isfinite(value) and value > 0


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_state_their_cuts(entry):
    assert entry["file"] == f"port_bench/configs/{entry['name']}.json"
    config = manifest.read_json(os.path.join(manifest.ROOT, entry["file"]))
    assert config["source"] == entry["source"]
    assert sorted(config["reduced"]) == sorted(entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    assert config["compute_dtype"] == config["overrides"]["TPU.COMPUTE_DTYPE"]


def test_chip_budget_fits_every_later_check():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
