"""BENCHMARK.json's form: names, units and
lengths; every metric's `moves`; every cell's files found by name."""

import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_sizes(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(man["paths"]) <= 16 and all(PATH.match(p) for p in man["paths"])
    assert len(man["command"]) <= 32 and all(1 <= len(w) <= 200 for w in man["command"])
    assert not any(w.startswith("/") or ".." in w for w in man["command"])
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    assert 1 <= len(man["configs"]) <= 24 and 1 <= len(man["workloads"]) <= 24
    assert 1 <= len(man["end_to_end"]) <= 16 and 1 <= len(man["per_layer"]) <= 128


def test_names_units_and_text(man):
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(("config", c["name"]))
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        names.append(("cell", w["name"]))
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    assert len(names) == len(set(names))
    for text in ([c["why"] for c in man["configs"]] + [c["source"] for c in man["configs"]]
                 + [w["why"] for w in man["workloads"]] + [m["layer"] for m in man["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len({(w["config"], w["traffic"]) for w in man["workloads"]}) == len(man["workloads"])


def test_metrics_bounds_and_moves(man):
    e2e = {m["name"] for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    assert "setup_s" in e2e
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        if "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_each_cell_finds_its_files(man):
    for c in man["configs"]:
        assert c["file"].startswith(man["paths"][0] + "/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in man["workloads"]:
        assert os.path.isfile(os.path.join(BENCH, "configs", w["config"] + ".json"))
        assert os.path.isfile(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    for m in man["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics", m["name"] + ".py"))
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}


def test_every_cell_reports_what_it_must(man):
    from fbench.harness import Cell

    for w in man["workloads"]:
        cell = Cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer)
        assert set(cell.config["limits"]) >= {"start", "T", "U", "p_rgh", "hs", "k", "Y", "I", "qr"}
