"""BENCHMARK.json against the benchmark's contract: names, units, keys and files."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT_KEYS = ("why", "layer", "source")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16 and len(bench["command"]) <= 32
    for word in bench["command"]:
        assert not word.startswith("/") and ".." not in word


def test_every_name_and_unit_uses_the_allowed_characters(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for entry in bench["configs"] + bench["workloads"] + bench["per_layer"]:
        for key in TEXT_KEYS:
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_entries_have_just_the_contract_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_are_unique_and_setup_is_there(bench):
    for group in ("configs", "workloads"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert "setup_s" in metrics
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_the_contract_asks(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = w["name"]
        mine = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
        assert any(m["name"] == "setup_s" for m in mine)
        assert any(m["name"] != "setup_s" for m in mine)
        layer = [m for m in bench["per_layer"] if cell in m.get("workloads", [cell])]
        assert layer, cell
        for m in layer:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)


def test_files_exist_for_every_name(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("perfbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "perfbench", "traffic", w["traffic"] + ".json"))
    metrics = os.path.join(ROOT, "perfbench", "metrics")
    for m in bench["per_layer"]:
        assert (os.path.exists(os.path.join(metrics, m["name"] + ".py"))
                or os.path.exists(os.path.join(metrics, m["name"].split(".")[0] + ".py"))), m["name"]
    for m in bench["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_run_seconds_fit_a_full_check_of_24_cells(bench):
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_four_chip_cells_within_a_quarter(bench):
    four = sum(1 for w in bench["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(bench["workloads"]) // 4)
