"""Nothing the harness loads is JAX or the JAX package, and the reference
loads nothing of the port: top-level module names compared whole."""

import ast
import subprocess
import sys

import pytest
import torch

from portbench.tests.shared import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "recommenders_tpu"}
REFERENCE = ROOT / "portbench" / "reference"


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(out.stdout.split())


def test_a_whole_run_loads_no_jax():
    # A whole run at the CPU's size: the harness, the port, the reference
    # and every per-layer metric.
    loaded = _loaded_after(
        "import sys, torch\n"
        "from portbench.tests.shared import tiny\n"
        "from portbench import run\n"
        "cell = 'scann-int8-100m.q256'\n"
        "rc = run.main(['--workload', cell, '--seed', '1', '--seconds', "
        "'0.2', '--trace', '1'], device=torch.device('cpu'), "
        "sizes=tiny(cell))\n"
        "assert rc == 0, rc\n")
    assert "recommenders_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_no_program():
    loaded = _loaded_after(
        "import portbench.reference.search, portbench.reference.quantize")
    assert not loaded & (FORBIDDEN | {"recommenders_tpu_torch"})


def test_the_reference_sources_import_only_torch():
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top in {"torch", "contextlib", "typing",
                               "__future__"}, (path.name, name)


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "scann-int8-100m.q256", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 2 and out.stdout == ""
