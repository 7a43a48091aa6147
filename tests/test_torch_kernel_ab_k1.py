"""`kernel_ab.py k1` rehearsed on the CPU, in a file of its own."""

import torch

import chip_smoke
from torch_threads import torch_threads  # noqa: F401 (autouse)


def test_kernel_ab_k1_times_the_step_and_the_floor_on_cpu():
    """`kernel_ab.py k1` at a tiny size on the CPU (the twin runs): the
    step's call and the one-run floor call, each timed both ways."""
    from recommenders_tpu_torch.tools import kernel_ab

    size = chip_smoke.TrainSize(users=64, items=256, dim=16, batch=64)
    k1 = kernel_ab.k1(chip_smoke, torch.device("cpu"), size)["k1"]
    assert sorted(k1) == ["floor", "step"]
    for reading in k1.values():
        assert len(reading["graph_ms"]) == len(reading["call_ms"]) == \
            kernel_ab.READS
        assert all(t > 0 for t in reading["graph_ms"] + reading["call_ms"])
