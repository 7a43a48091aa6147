"""A `torch.profiler` window read back as device operations and host
activity: busy time, device operations (kernels, copies, fills) by name
and kernel family, and idle gaps by what the host was doing.

The trace goes to a Chrome-trace file in a fresh temporary directory
(under `TMPDIR`), is read, and is deleted.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile

import torch

from portbench import yardstick

REQUEST_SPAN = "portbench.request"
# Host events that say what the host was doing during a device gap.
_HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
              "python_function"}
# Device operations: kernels, and the copies and fills the card runs.
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
# Host events a gap's label search walks back over from its midpoint.
_LOOKBACK = 2000


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    requests: int
    kernels: list            # (name, family or None, seconds, is kernel)
    idle: dict               # host activity → idle seconds
    spans: list = dataclasses.field(default_factory=list)
    # (name, seconds) of every other host annotation in the window: the
    # spans a program records with `torch.profiler.record_function`.

    def seconds(self, family=None, other=False) -> float:
        """Kernel seconds of `family`, or of no named family (`other`),
        or of all kernels."""
        if other:
            return sum(s for _, f, s, _ in self.kernels if f is None)
        return sum(s for _, f, s, _ in self.kernels
                   if family is None or f == family)

    def launches(self) -> int:
        """Kernels launched (copies and fills not counted)."""
        return sum(1 for *_, kernel in self.kernels if kernel)

    def breakdown(self) -> dict:
        by_name = {}
        for name, _, s, _ in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[n[:200], s] for n, s in gaps]}


def activities() -> list:
    """The host, and the device where there is one."""
    out = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        out.append(torch.profiler.ProfilerActivity.CUDA)
    return out


def read_profile(prof) -> "Trace":
    """The `Trace` of a finished `torch.profiler.profile`."""
    with tempfile.TemporaryDirectory(prefix="portbench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return read(events)


def read(events: list) -> Trace:
    """The `Trace` of Chrome-trace events: the window runs from the first
    request span's start to the last one's end."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") == REQUEST_SPAN]
    if not spans:
        return Trace(0.0, 0.0, 0, [], {})
    begin = min(float(e["ts"]) for e in spans)
    end = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    kernels, intervals = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
            continue
        lo = max(float(e["ts"]), begin)
        hi = min(float(e["ts"]) + float(e["dur"]), end)
        if hi <= lo:
            continue
        kernels.append((e["name"], yardstick.family(e["name"]),
                        (hi - lo) / 1e6, e["cat"] == "kernel"))
        intervals.append((lo, hi))
    intervals.sort()
    busy, gaps, covered = 0.0, [], begin
    for lo, hi in intervals:
        if lo > covered:
            gaps.append((covered, lo))
        if hi > covered:
            busy += hi - max(lo, covered)
            covered = hi
    if end > covered:
        gaps.append((covered, end))
    marks = [(e["name"], (min(float(e["ts"]) + float(e["dur"]), end)
                          - max(float(e["ts"]), begin)) / 1e6)
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") != REQUEST_SPAN
             and begin <= float(e["ts"]) < end]
    return Trace(window_s=(end - begin) / 1e6, busy_s=busy / 1e6,
                 requests=len(spans), kernels=kernels,
                 idle=_label_gaps(events, gaps), spans=marks)


def _label_gaps(events: list, gaps: list) -> dict:
    """Idle seconds by the innermost host event under each gap's
    midpoint (the request span itself if nothing narrower)."""
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in _HOST_CATS)
    starts = [h[0] for h in host]
    idle = {}
    for lo, hi in gaps:
        mid = (lo + hi) / 2
        best = None
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - _LOOKBACK, -1), -1):
            s, e, name = host[j]
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        label = best[2] if best else "no host event"
        idle[label] = idle.get(label, 0.0) + (hi - lo) / 1e6
    return idle
