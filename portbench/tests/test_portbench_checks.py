"""`correct` at a size the CPU holds: a sound run passes; the control
(the reference at int4 in the program's place) and each fault a serving
cell can have, planted under the timed path, fail."""

import importlib.util
import json
import sys

import pytest
import torch

from conftest import ROOT
from conftest import tiny
from portbench import control
from portbench import run

CPU = torch.device("cpu")
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _limits(cell: str) -> dict:
    return json.loads((ROOT / "portbench" / "workloads"
                       / f"{cell}.json").read_text())["limits"]


def _run(cell: str, capsys, wrap=None) -> dict:
    rc = run.main(["--workload", cell, "--seed", "2147483659", "--seconds",
                   "0.3", "--trace", "0"], device=CPU, wrap=wrap,
                  sizes=tiny(cell))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, capsys):
    result = _run(cell, capsys)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"qps", "request_p95_ms", "setup_s"}


@pytest.mark.parametrize("config", ["scann-int8-100m", "bucketed-int8-100m"])
def test_the_control_fails_every_number(config, capsys):
    cell = f"{config}.q256"
    assert control.main(["--config", config, "--seeds", "1", "2",
                         "--seconds", "0.2"], device=CPU,
                        sizes=tiny(cell)) == 0
    for line in capsys.readouterr().out.strip().splitlines():
        reading = json.loads(line)
        limits = _limits(reading["cell"])
        for name, limit in limits.items():
            assert reading["program"][name] <= limit, (name, reading)
            assert reading["control"][name] > limit, (name, reading)
        for fault, found in reading["faults"].items():
            assert any(found[n] > limits[n] for n in limits), (fault, found)


class Stale:
    """Answers each request with the previous request's answer."""

    def __init__(self, index):
        self.index, self.last = index, None

    def __call__(self, queries, k):
        out = self.index(queries, k)
        last, self.last = self.last, out
        return out if last is None else last


class HalfBatch:
    """Answers the first half of the queries; the second half gets the
    first half's answers."""

    def __init__(self, index):
        self.index = index

    def __call__(self, queries, k):
        half = queries.shape[0] // 2
        scores, ids = self.index(queries[:half], k)
        return torch.cat([scores, scores]), torch.cat([ids, ids])


class Altered:
    """Changes one returned row of every answer to another row."""

    def __init__(self, index):
        self.index = index

    def __call__(self, queries, k):
        scores, ids = self.index(queries, k)
        ids = ids.clone()
        ids[0, -1] = (ids[0, -1] + 1) % 20000
        while bool((ids[0, :-1] == ids[0, -1]).any()):
            ids[0, -1] = (ids[0, -1] + 1) % 20000
        return scores, ids


class DroppedRows:
    """Leaves every 100th stored row out of the scan: its scale reads 0
    while the index answers, and is put back between requests."""

    def __init__(self, index):
        self.index = index
        self.name = ("_leaf_scales" if hasattr(index, "_leaf_scales")
                     else "_scales")

    def __call__(self, queries, k):
        kept = getattr(self.index, self.name)
        dropped = kept.clone()
        dropped.view(-1)[::100] = 0.0
        setattr(self.index, self.name, dropped)
        try:
            return self.index(queries, k)
        finally:
            setattr(self.index, self.name, kept)


class HalfProbes:
    """A ScaNN index that probes half of its leaves."""

    def __init__(self, index):
        self.index = index
        index._num_probes //= 2

    def __call__(self, queries, k):
        return self.index(queries, k)


class WrongLeaves:
    """A ScaNN partition whose centroids no longer match their leaves:
    the rows sit in the wrong leaves, and the reference, which follows
    the partition the index built, follows it too."""

    def __init__(self, index):
        self.index = index
        index._centroids = torch.roll(index._centroids, 1, dims=0)

    def __call__(self, queries, k):
        return self.index(queries, k)


FAULTS = [(cell, fault) for cell in CELLS
          for fault in (Stale, HalfBatch, Altered, DroppedRows, HalfProbes,
                        WrongLeaves)
          if cell.startswith("scann") or fault not in (HalfProbes,
                                                       WrongLeaves)]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault, capsys):
    result = _run(cell, capsys, wrap=fault)
    assert not result["correct"], result["checks"]


def test_a_metric_that_loads_jax_prints_no_result(tmp_path, monkeypatch,
                                                  capsys):
    # A stub named `jax`, loaded by a metric module that a later change
    # could add: the harness has to see it after every metric is read.
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    planted = tmp_path / "planted_metric.py"
    planted.write_text("import jax  # noqa: F401\n\n\n"
                       "def read(reading):\n    return None\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    original = run.load_metric

    def load_metric(name):
        spec = importlib.util.spec_from_file_location("planted_metric",
                                                      planted)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        return original(name)

    monkeypatch.setattr(run, "load_metric", load_metric)
    cell = CELLS[0]
    try:
        rc = run.main(["--workload", cell, "--seed", "5", "--seconds",
                       "0.2", "--trace", "1"], device=CPU,
                      sizes=tiny(cell))
    finally:
        sys.modules.pop("jax", None)
    captured = capsys.readouterr()
    assert rc == 3 and captured.out == ""
    assert "loaded in this process: jax" in captured.err
