"""A whole run of each cell through the port's kernels at its CPU sizes
(`tiny/<config>.json`; marked `cuda`: skips without a card). A traced
run reads every per-layer metric listed for the cell, but those its
runner's contract names as silent on the card. On the card:
`python -m pytest portbench/tests/test_portbench_card.py -q`."""

import json

import pytest

from portbench import run
from portbench.tests import shared
from portbench.tests.shared import cuda_device  # noqa: F401 - a fixture

CELLS = shared.cells()


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_run_on_the_card_is_correct(cell, trace, cuda_device,
                                            capsys):
    rc = run.main(["--workload", cell, "--seed", "5", "--seconds", "0.5",
                   "--trace", str(trace)], device=cuda_device,
                  sizes=shared.tiny(cell))
    assert rc == 0
    captured = capsys.readouterr()
    card = [line for line in captured.err.splitlines()
            if line.startswith("card: ")]
    assert card
    print(card[0])   # the card's name and power limit, shown by -rP
    result = json.loads(captured.out.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0
        silent = shared.contract_of(cell).SILENT_ON_CARD
        for name in shared.applied("per_layer", cell):
            assert (name in result["metrics"]) != (name in silent), name
