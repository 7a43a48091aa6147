"""What the harness's tests share, each found by name under a root (the
repo's, or a copy of the harness in a test): the manifest, a cell's CPU
sizes (`portbench/tiny/<config>.json`) and its runner's contract
(`portbench/contracts/<runner>.py`). A name without its file raises
`LookupError` naming the file; nothing falls through to another's.

Imported as `portbench.tests.shared`, not from `conftest`: another
suite's `conftest` can take that name first."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from portbench.run import applies

ROOT = Path(__file__).resolve().parents[2]
SIZES = ("config", "traffic", "check")


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load(root / "BENCHMARK.json")


def cells(root: Path = ROOT) -> list:
    return [w["name"] for w in manifest(root)["workloads"]]


def cell_file(cell: str, root: Path = ROOT) -> dict:
    return load(root / "portbench" / "workloads" / f"{cell}.json")


def config_file(name: str, root: Path = ROOT) -> dict:
    entry = {c["name"]: c for c in manifest(root)["configs"]}[name]
    return load(root / entry["file"])


def tiny(cell: str, root: Path = ROOT) -> dict:
    """The sizes at which a whole run of `cell` holds on the CPU: its
    configuration's `tiny/<config>.json`, as `run.main`'s `sizes`."""
    config = cell_file(cell, root)["config"]
    path = root / "portbench" / "tiny" / f"{config}.json"
    if not path.exists():
        raise LookupError(f"configuration {config!r} (cell {cell!r}) has no "
                          f"CPU sizes: portbench/tiny/{config}.json")
    sizes = load(path)
    return {key: sizes[key] for key in SIZES if key in sizes}


def contract(runner: str, root: Path = ROOT):
    """The module `portbench/contracts/<runner>.py` under `root`."""
    path = root / "portbench" / "contracts" / f"{runner}.py"
    if not path.exists():
        raise LookupError(f"runner {runner!r} has no contract: "
                          f"portbench/contracts/{runner}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_contract_{runner}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def contract_of(cell: str, root: Path = ROOT):
    config = config_file(cell_file(cell, root)["config"], root)
    return contract(config["runner"], root)


def faults_of(cell: str, root: Path = ROOT) -> list:
    """The faults the cell's runner declares for its configuration."""
    config = config_file(cell_file(cell, root)["config"], root)
    return [fault for fault, holds in contract(config["runner"],
                                               root).FAULTS
            if holds(config)]


def applied(kind: str, cell: str, root: Path = ROOT) -> list:
    """The names of the `kind` metrics (`end_to_end` or `per_layer`)
    that `BENCHMARK.json` applies to `cell`, as a run applies them."""
    return [m["name"] for m in manifest(root)[kind] if applies(m, cell)]


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
