"""`correct` at a size the CPU holds (each configuration's
`tiny/<config>.json`): a sound run passes; the control (the reference a
precision down in the program's place) and each fault that the cell's
runner contract (`contracts/<runner>.py`) declares for its configuration,
planted under the timed path, fail; a traced run reads the cell's listed
per-layer metrics but those the contract names as silent on the CPU."""

import importlib.util
import json
import sys

import pytest
import torch

from portbench import run
from portbench.tests import shared

CPU = torch.device("cpu")
CELLS = shared.cells()
# Each configuration once, with the first of its cells: the control
# serves all of a configuration's cells in one process.
CONFIGS = {}
for _cell in CELLS:
    CONFIGS.setdefault(shared.cell_file(_cell)["config"], _cell)


def _run(cell: str, capsys, wrap=None, trace=0) -> dict:
    rc = run.main(["--workload", cell, "--seed", "2147483659", "--seconds",
                   "0.3", "--trace", str(trace)], device=CPU, wrap=wrap,
                  sizes=shared.tiny(cell))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, capsys):
    result = _run(cell, capsys)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == set(shared.applied("end_to_end", cell))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_the_control_fails_every_number(config):
    cell = CONFIGS[config]
    contract = shared.contract_of(cell)
    readings = contract.control(config, shared.tiny(cell), CPU)
    assert readings
    for reading in readings:
        limits = shared.cell_file(reading["cell"])["limits"]
        for name, limit in limits.items():
            assert reading["program"][name] <= limit, (name, reading)
        for name in contract.CONTROL_FAILS:
            assert reading["control"][name] > limits[name], (name, reading)
        assert any(reading["control"][n] > limits[n] for n in limits)
        for fault, found in reading["faults"].items():
            assert any(found[n] > limits[n] for n in limits), (fault, found)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_reads_its_listed_metrics(cell, capsys):
    result = _run(cell, capsys, trace=1)
    assert result["correct"]
    silent = shared.contract_of(cell).SILENT_ON_CPU
    for name in shared.applied("per_layer", cell):
        assert (name in result["metrics"]) != (name in silent), name


FAULTS = [(cell, fault) for cell in CELLS
          for fault in shared.faults_of(cell)]


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
                      sizes=shared.tiny(cell))
    finally:
        sys.modules.pop("jax", None)
    captured = capsys.readouterr()
    assert rc == 3 and captured.out == ""
    assert "loaded in this process: jax" in captured.err
