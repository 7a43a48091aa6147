"""A cell of a second runner comes in by new files and appended
`BENCHMARK.json` entries alone.

`second_runner/` holds what a runner's first cell brings, laid out as in
the repo (a `model_config` PR brings the same, with its own names):

- `portbench/runners/<runner>.py`: `run(config, traffic, check, seed,
  seconds, trace, device, t0, wrap)`, returning an outcome with
  `end_to_end`, `attempted`, `failed`, `numbers`, `memory_peak_bytes`
  and `reading` (what its metrics read: `reading.trace` a
  `tracing.Trace` on a traced run, else None); `wrap` wraps the system
  under test, as a planted fault does;
- `portbench/contracts/<runner>.py`: `NUMBERS`, `END_TO_END`, `FAULTS`,
  `CONTROL_FAILS`, `control`, `SILENT_ON_CPU`, `SILENT_ON_CARD`
  (`contracts/index_serving.py` says what each means);
- `portbench/configs/<config>.json`: `name`, `runner`, `source`,
  `deployment`, `reduced` (each cut key with its published value) and
  the sizes;
- `portbench/tiny/<config>.json`: the `config`, `traffic` and `check`
  sizes a CPU run takes, and under `cuts` a line for each saying what
  it leaves;
- `portbench/traffic/<mix>.json`, `portbench/workloads/<cell>.json`
  (`config`, `traffic`, `check`, `limits` on the contract's `NUMBERS`);
- `portbench/metrics/<name>.py` for each per-layer metric: `read(reading)`,
  None where there is nothing to read;
- `manifest_entries.json`: the entries appended to `BENCHMARK.json`'s
  `configs`, `workloads` and `per_layer`.

The tests copy the harness into a temporary directory, add those files
and append those entries, check that nothing that was there changed, and
run the copy's own tests of the new cell: the manifest's, a sound run,
the control, a traced run and each declared fault, at the CPU sizes.
Copies with one piece missing or wrong fail the manifest's tests by the
piece's name.
"""

import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest

from portbench.tests import shared
from portbench.tests import test_portbench_manifest as manifest_tests

STUB = Path(__file__).resolve().parent / "second_runner"
CELL = "linear-d64.pairs64"
CONFIG = "linear-d64"
RUNNER = "linear_scoring"
LISTS = ("configs", "workloads", "per_layer")


def _harness(root: Path, tests: bool) -> Path:
    """A copy of the harness under `root`: `BENCHMARK.json` and
    `portbench/`, its tests too where `tests`."""
    skip = ["__pycache__"] + ([] if tests else ["tests"])
    shutil.copytree(shared.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns(*skip))
    shutil.copy2(shared.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def add_second_runner(root: Path) -> list:
    """Adds `second_runner/`'s files under `root` (each new there) and
    appends its entries to `BENCHMARK.json`; returns the files added."""
    added = []
    for path in sorted((STUB / "portbench").rglob("*")):
        if path.is_dir() or "__pycache__" in path.parts:
            continue
        target = root / path.relative_to(STUB)
        assert not target.exists(), target
        target.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(path, target)
        added.append(target.relative_to(root).as_posix())
    manifest = shared.manifest(root)
    entries = shared.load(STUB / "manifest_entries.json")
    assert set(entries) <= set(LISTS)
    for key, extra in entries.items():
        manifest[key] = manifest[key] + extra
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return added


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = _harness(tmp_path_factory.mktemp("harness"), tests=True)
    return root, add_second_runner(root)


def test_the_second_runner_adds_files_and_appends_entries(copy):
    root, added = copy
    assert added and all(
        (STUB / path).exists() for path in added)
    for path in (shared.ROOT / "portbench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            kept = root / path.relative_to(shared.ROOT)
            assert kept.read_bytes() == path.read_bytes(), path
    before, after = shared.manifest(), shared.manifest(root)
    assert set(after) == set(before)
    for key, value in before.items():
        if key in LISTS:
            assert after[key][:len(value)] == value, key
        else:
            assert after[key] == value, key


def test_the_copy_passes_its_own_tests_of_the_new_cell(copy):
    root, _ = copy
    report = root / "report.xml"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", f"--junitxml={report}",
         "portbench/tests/test_portbench_manifest.py",
         "portbench/tests/test_portbench_checks.py",
         "portbench/tests/test_portbench_card.py",
         "-k", f"test_portbench_manifest or {CONFIG}"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    outcomes = {}
    for case in ET.parse(report).iter("testcase"):
        kinds = {child.tag for child in case}
        outcomes[case.get("name")] = ("skipped" if "skipped" in kinds
                                      else "failed" if kinds & {
                                          "failure", "error"}
                                      else "passed")
    for name in (f"test_a_sound_run_is_correct[{CELL}]",
                 f"test_the_control_fails_every_number[{CONFIG}]",
                 f"test_a_traced_cpu_run_reads_its_listed_metrics[{CELL}]",
                 f"test_a_planted_fault_is_not_correct[{CELL}-HalfPairs]",
                 "test_every_name_has_its_files",
                 "test_cuts_as_the_guide_has_them",
                 "test_tiny_files_change_known_keys_and_say_why"):
        assert outcomes.get(name) == "passed", (name, outcomes)
    # The cell's planted faults are its own runner's, none of the
    # index's; the card's runs skip here.
    planted = [n for n in outcomes
               if n.startswith("test_a_planted_fault_is_not_correct")]
    assert planted == [f"test_a_planted_fault_is_not_correct[{CELL}-"
                       "HalfPairs]"]
    card = [n for n in outcomes if n.startswith("test_a_small_run")]
    assert len(card) == 2 and all(outcomes[n] in ("passed", "skipped")
                                  for n in card)


def test_faults_follow_each_cells_runner(tmp_path):
    root = _harness(tmp_path, tests=False)
    add_second_runner(root)
    assert [f.__name__ for f in shared.faults_of(CELL, root)] == [
        "HalfPairs"]
    for cell in shared.cells():
        assert ([f.__name__ for f in shared.faults_of(cell, root)]
                == [f.__name__ for f in shared.faults_of(cell)])
    names = {c: [f.__name__ for f in shared.faults_of(c)]
             for c in shared.cells()}
    assert names["scann-int8-100m.q256"] == [
        "Stale", "HalfBatch", "Altered", "DroppedRows", "HalfProbes",
        "WrongLeaves"]
    assert names["bucketed-int8-100m.q256"] == [
        "Stale", "HalfBatch", "Altered", "DroppedRows"]


def _without(relative: str):
    def broken(root: Path):
        (root / relative).unlink()
    return broken


def _edit(relative: str, change):
    def broken(root: Path):
        path = root / relative
        data = json.loads(path.read_text())
        change(data)
        path.write_text(json.dumps(data))
    return broken


def _limits_of_the_index(cell: dict):
    cell["limits"]["recall_loss"] = 0.06


def _uncut_in_the_manifest(manifest: dict):
    manifest["configs"][-1]["reduced"] = []


def _a_width_cut(config: dict):
    config["reduced"]["dim"] = 128


def _a_width_cut_in_the_manifest(manifest: dict):
    manifest["configs"][-1]["reduced"] = ["rows", "dim"]


def _a_cut_without_its_line(sizes: dict):
    del sizes["cuts"]["config.rows"]


def _a_size_of_no_key(sizes: dict):
    sizes["config"]["row"] = 16
    sizes["cuts"]["config.row"] = "a key the configuration does not have"


def _no_deployment(config: dict):
    del config["deployment"]


BROKEN = {
    "no_tiny_file": (_without(f"portbench/tiny/{CONFIG}.json"),
                     "test_every_name_has_its_files", LookupError,
                     f"portbench/tiny/{CONFIG}.json"),
    "no_contract": (_without(f"portbench/contracts/{RUNNER}.py"),
                    "test_every_name_has_its_files", LookupError,
                    f"portbench/contracts/{RUNNER}.py"),
    "limits_of_another_runner": (
        _edit(f"portbench/workloads/{CELL}.json", _limits_of_the_index),
        "test_every_name_has_its_files", AssertionError, CELL),
    "a_cut_the_manifest_omits": (
        _edit("BENCHMARK.json", _uncut_in_the_manifest),
        "test_cuts_as_the_guide_has_them", AssertionError, CONFIG),
    "a_width_cut": (
        lambda root: (_edit(f"portbench/configs/{CONFIG}.json",
                            _a_width_cut)(root),
                      _edit("BENCHMARK.json",
                            _a_width_cut_in_the_manifest)(root)),
        "test_cuts_as_the_guide_has_them", AssertionError,
        "dim is a width"),
    "no_deployment": (
        _edit(f"portbench/configs/{CONFIG}.json", _no_deployment),
        "test_cuts_as_the_guide_has_them", AssertionError,
        f"{CONFIG} states no deployment"),
    "a_cut_without_its_line": (
        _edit(f"portbench/tiny/{CONFIG}.json", _a_cut_without_its_line),
        "test_tiny_files_change_known_keys_and_say_why", AssertionError,
        f"{CONFIG}.json"),
    "a_size_of_no_key": (
        _edit(f"portbench/tiny/{CONFIG}.json", _a_size_of_no_key),
        "test_tiny_files_change_known_keys_and_say_why", AssertionError,
        "config.row"),
}


@pytest.mark.parametrize("case", list(BROKEN))
def test_a_broken_copy_fails_the_manifest_by_name(case, tmp_path):
    breaks, test, error, name = BROKEN[case]
    root = _harness(tmp_path, tests=False)
    add_second_runner(root)
    getattr(manifest_tests, test)(root)      # whole, it passes
    breaks(root)
    with pytest.raises(error) as raised:
        getattr(manifest_tests, test)(root)
    assert name in str(raised.value), raised.value
