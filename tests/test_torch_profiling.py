"""The port's `utils/profiling.py` on the CPU, beside the JAX module:
`StepTimer` gives the same summary keys and warm-up accounting for the
same step times, `annotate` names a region in the trace, and `trace`
writes a Chrome-trace JSON (host events only here; the card's kernels
show where CUDA is)."""

import glob
import json
import os
import time

import torch

from recommenders_tpu.utils import profiling as jax_profiling
from recommenders_tpu_torch.utils import profiling
from torch_threads import torch_threads  # noqa: F401 (autouse)


def test_step_timer_matches_the_jax_timer():
    ours, theirs = profiling.StepTimer(warmup=2), jax_profiling.StepTimer(
        warmup=2)
    for i in range(5):
        for timer in (ours, theirs):
            with timer.step(batch_size=100):
                time.sleep(0.01)
    a, b = ours.summary(), theirs.summary()
    assert set(a) == set(b) == {"steps_timed", "mean_step_ms",
                                "examples_per_sec"}
    assert a["steps_timed"] == b["steps_timed"] == 3
    assert 5 <= a["mean_step_ms"] < 100
    assert abs(a["examples_per_sec"] - b["examples_per_sec"]) < 0.5 * (
        b["examples_per_sec"])


def test_step_timer_counts_examples_only_when_given():
    timer = profiling.StepTimer(warmup=0)
    with timer.step():
        pass
    assert timer.summary()["steps_timed"] == 1
    assert timer.examples_per_sec == 0.0


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    logdir = str(tmp_path / "prof")
    with profiling.trace(logdir):
        with profiling.annotate("matmul_region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum().item()
    files = glob.glob(os.path.join(logdir, "trace_*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "matmul_region" in names
    assert any("mm" in str(n) for n in names)
