"""Profiling hooks: `torch.profiler` tracing + throughput accounting.

Port of `recommenders_tpu/utils/profiling.py`. Wrap code in
`trace(logdir)` to write a Chrome-trace JSON of the host and, on a CUDA
machine, the device timeline (Perfetto or `chrome://tracing` open it),
name regions with `annotate`, and time steady-state steps with
`StepTimer`, which skips warm-up steps.

```python
with profiling.trace("/tmp/profile"):
    for batch in batches:
        with profiling.annotate("train_step"):
            state, loss = trainer.train_step(state, batch)
```
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Captures a `torch.profiler` trace of the enclosed block (CPU, and
    CUDA kernels where CUDA is available) into
    `logdir/trace_<ns>.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region visible in profiler timelines (`record_function`)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Steady-state step timing that excludes warm-up steps.

    The timed block must wait for the device itself (read the loss, or
    `torch.cuda.synchronize()`): CUDA work returns before it finishes.

    ```python
    timer = StepTimer(warmup=3)
    for batch in batches:
        with timer.step(batch_size):
            state, loss = trainer.train_step(state, batch)
            float(loss)
    print(timer.summary())
    ```
    """

    def __init__(self, warmup: int = 3) -> None:
        self.warmup = warmup
        self._steps = 0
        self._timed_steps = 0
        self._total_time = 0.0
        self._total_examples = 0

    @contextlib.contextmanager
    def step(self, batch_size: Optional[int] = None):
        start = time.perf_counter()
        yield
        elapsed = time.perf_counter() - start
        self._steps += 1
        if self._steps > self.warmup:
            self._timed_steps += 1
            self._total_time += elapsed
            if batch_size:
                self._total_examples += batch_size

    @property
    def mean_step_seconds(self) -> float:
        return self._total_time / max(self._timed_steps, 1)

    @property
    def examples_per_sec(self) -> float:
        return self._total_examples / max(self._total_time, 1e-12)

    def summary(self) -> dict:
        return {
            "steps_timed": self._timed_steps,
            "mean_step_ms": self.mean_step_seconds * 1e3,
            "examples_per_sec": self.examples_per_sec,
        }
