"""A whole run of each cell through the port's kernels at a small size
(marked `cuda`: skips without a card). On the card:
`python -m pytest portbench/tests/test_portbench_card.py -q`."""

import json

import pytest

from conftest import ROOT
from conftest import tiny
from portbench import run

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_run_on_the_card_is_correct(cell, trace, cuda_device,
                                            capsys):
    sizes = tiny(cell)
    rc = run.main(["--workload", cell, "--seed", "5", "--seconds", "0.5",
                   "--trace", str(trace)], device=cuda_device, sizes=sizes)
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0
        assert "index.launches" in result["metrics"]
