"""Profiling hooks: `torch.profiler` tracing, spans, set-up phases and
throughput accounting.

Port of `recommenders_tpu/utils/profiling.py`. Wrap code in
`trace(logdir)` to write a Chrome-trace JSON of the host and, on a CUDA
machine, the device timeline (Perfetto or `chrome://tracing` open it),
name regions with `annotate`, time set-up passes with `phase`, and time
steady-state steps with `StepTimer`, which skips warm-up steps.

`annotate` costs one check when no profiler records, and nothing enters
the trace; under a recording profiler its span lands as a
`user_annotation` on the same clock as the card's kernels, copies and
fills, nested by time in the caller's spans. The port's served paths
record these spans:

  - `scann.search`: `ScaNN.__call__`, the index's whole host call;
  - `scann.probe`: the centroid product and the probe lists ahead of K5;
  - `k5.launch`: K5's plan, checks and dispatcher call (the op's own
    `recommenders_tpu_torch::probed_bucketed_scores` event nests inside);
  - `scann.merge`: after K5, the restored order, top-k, rows and ids;
  - `bucketed.search`: `Bucketed.__call__`, the index's whole host call;
  - `k3.launch`: K3's plan, checks and dispatcher call;
  - `bucketed.merge`: after K3, the top-k over the buckets and its rows;
  - `ranking.forward`: `Ranking.forward` / `Ranking.logits`, the model's
    whole host call;
  - `ranking.lookup`: every sparse feature's lookup and pooling;
  - `pool.launch`: `ops.pooled_lookup`'s checks, grouping and dispatcher
    call on the card (the CPU twin records none);
  - `ranking.dense`: the bottom stack, the interaction and the top stack.

`ScaNN.index_streamed` records one `phase` a pass, each synchronized
with the index's device at its end: `scann.build.kmeans` (stride sample
and k-means), `scann.build.assign` (top-R assignment and packing) and
`scann.build.scatter` (quantize or cast, and scatter). `phases()` returns
the records (name, start, end on `time.perf_counter`, enclosing phase),
`clear_phases()` empties them; nothing is written to disk.

```python
with profiling.trace("/tmp/profile"):
    for batch in batches:
        with profiling.annotate("train_step"):
            state, loss = trainer.train_step(state, batch)

# A ScaNN request's spans, and the build's passes:
index = approximate.ScaNN(..., scoring_buckets=8192, device="cuda")
index.index_streamed(batches, num_rows=n)
print([(p.name, p.seconds) for p in profiling.phases()])
with profiling.trace("/tmp/profile"):   # scann.search ⊃ scann.probe,
    scores, ids = index(queries, k=100)  # k5.launch, scann.merge
```
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time
from typing import List, Optional

import torch

# The records `phase` keeps, oldest first dropped past this many.
MAX_PHASES = 256


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


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """Named region visible in profiler timelines (`record_function`)
    while a `torch.profiler` session records; otherwise, and inside a
    `torch.export` or `torch.compile` trace, a shared null context, so
    an unprofiled call pays one check and a traced program holds no
    profiler op."""
    if (not torch._C._autograd._profiler_enabled()
            or torch.compiler.is_compiling()):
        return _OFF
    return torch.profiler.record_function(name)


@dataclasses.dataclass(frozen=True)
class Phase:
    """One `phase`: its name, start and end on `time.perf_counter`, and
    the name of the phase that enclosed it (None at the top)."""

    name: str
    start: float
    end: float
    parent: Optional[str]

    @property
    def seconds(self) -> float:
        return self.end - self.start


class _Open(threading.local):
    """The names of the phases open in this thread, innermost last."""

    def __init__(self) -> None:
        self.names: List[str] = []


_phases: collections.deque = collections.deque(maxlen=MAX_PHASES)
_open = _Open()


@contextlib.contextmanager
def phase(name: str, device=None):
    """A coarse span for set-up, always recorded (into `phases()`) and,
    while a profiler records, emitted as `annotate` does. On exit it
    synchronizes `device` when that is a CUDA device, so the span holds
    the pass's device work and not only its enqueue. A phase that raises
    is not recorded."""
    stack = _open.names
    parent = stack[-1] if stack else None
    stack.append(name)
    start = time.perf_counter()
    try:
        with annotate(name):
            yield
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    finally:
        stack.pop()
    _phases.append(Phase(name, start, time.perf_counter(), parent))


def phases() -> List[Phase]:
    """The recorded phases, oldest first (at most `MAX_PHASES`)."""
    return list(_phases)


def clear_phases() -> None:
    _phases.clear()


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
