"""`BENCHMARK.json` and the files it names keep to the benchmark's
contract."""

import json
import re

from conftest import ROOT
from portbench import compare

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH = ROOT / "portbench"


def test_keys_names_and_units():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in MANIFEST["configs"]:
        assert NAME.match(c["name"]) and c["reduced"] == []
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert set(e2e) == {"qps", "request_p95_ms", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_moves_is_reported_by_its_cells():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert "workloads" not in target or cell in target["workloads"]


def test_every_name_has_its_files():
    for c in MANIFEST["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"]
        assert config["source"] == c["source"]
        assert (BENCH / "runners" / f"{config['runner']}.py").exists()
    for w in MANIFEST["workloads"]:
        cell = json.loads((BENCH / "workloads"
                           / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert set(cell["limits"]) == set(compare.NUMBERS)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    for m in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()


def test_paths_and_run_length_fit_the_check():
    assert MANIFEST["paths"] == ["portbench"]
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    seconds = MANIFEST["run_seconds"]
    assert 1 <= seconds <= 51
    # A full check of 24 cells: 2 + 14 runs a cell, each with 60 s of
    # room, two compiles a cell, 1200 s spare.
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200
