"""`tests/torch_threads.py`: every port test module takes the fixture,
and a share gives torch, and the processes it starts, its threads and
gives them back."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import torch

import torch_threads as threads_lib
from torch_threads import torch_threads  # noqa: F401 (autouse)

PORT_TESTS = sorted(Path(__file__).parent.glob("test_torch_*.py"))


def _takes_the_fixture(path: Path) -> bool:
    return any(
        isinstance(node, ast.ImportFrom) and node.module == "torch_threads"
        and any(alias.name == "torch_threads" for alias in node.names)
        for node in ast.parse(path.read_text()).body)


def test_every_port_test_module_takes_the_fixture():
    assert len(PORT_TESTS) > 70
    assert [p.name for p in PORT_TESTS if not _takes_the_fixture(p)] == []


def test_a_share_sets_and_restores_the_threads():
    cores = len(os.sched_getaffinity(0))
    assert threads_lib.share(1) == cores
    assert threads_lib.share(cores + 1) == 1
    before, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    with threads_lib.thread_share(cores + 1) as threads:
        assert threads == torch.get_num_threads() == 1
        child = subprocess.run(
            [sys.executable, "-c",
             "import torch; print(torch.get_num_threads())"],
            capture_output=True, text=True, check=True, timeout=300)
        assert child.stdout.split() == ["1"]
    assert torch.get_num_threads() == before
    assert os.environ.get("OMP_NUM_THREADS") == env
