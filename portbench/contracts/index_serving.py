"""What a cell of `runners/index_serving.py` has to satisfy, for the
harness's own tests (`portbench/tests/`); no run loads this file.

- `NUMBERS`: the names `correct` compares; each cell's `limits` has
  exactly these.
- `END_TO_END`: the end-to-end metrics a run reports; every one that
  `BENCHMARK.json` applies to a cell of this runner is among them.
- `FAULTS`: each fault the timed path can have, planted by `run.main`'s
  `wrap` around the built index, with the configurations it applies to
  (a predicate on the configuration's file); each has to read not
  correct.
- `control(config, sizes, device)`: the control's readings at the given
  sizes, one dict a seed and cell (`cell`, and `program`, `control` and
  each of `faults` as numbers); `CONTROL_FAILS` are the numbers the
  control has to fail each of.
- `SILENT_ON_CPU`, `SILENT_ON_CARD`: the per-layer metrics listed for a
  cell that a traced run at the CPU sizes (`tiny/<config>.json`) cannot
  read, on the CPU and on the card, each with the reason; every other
  listed metric has to read.
"""

import contextlib
import io
import json

import torch

from portbench import compare
from portbench import control as control_program

NUMBERS = compare.NUMBERS
END_TO_END = ("qps", "request_p95_ms", "setup_s")
CONTROL_FAILS = NUMBERS

_NO_DEVICE = "the CPU twins run no kernel: the trace holds no device time"
SILENT_ON_CPU = {
    "k5_roofline": _NO_DEVICE,
    "k3_roofline": _NO_DEVICE,
    "mfu": _NO_DEVICE,
    "device.idle_share": _NO_DEVICE,
    "index.other_device_ms": _NO_DEVICE,
    "index.launches": _NO_DEVICE,
    "ops.launch_us": "the wrappers run their twins and record no launch span",
}
SILENT_ON_CARD = {}


class Stale:
    """Answers each request with the previous request's answer."""

    def __init__(self, index):
        self.index, self.last = index, None

    def __call__(self, queries, k):
        out = self.index(queries, k)
        last, self.last = self.last, out
        return out if last is None else last


class HalfBatch:
    """Answers the first half of the queries; the second half gets the
    first half's answers."""

    def __init__(self, index):
        self.index = index

    def __call__(self, queries, k):
        half = queries.shape[0] // 2
        scores, ids = self.index(queries[:half], k)
        return torch.cat([scores, scores]), torch.cat([ids, ids])


class Altered:
    """Changes one returned row of every answer to another row."""

    def __init__(self, index):
        self.index = index

    def __call__(self, queries, k):
        scores, ids = self.index(queries, k)
        ids = ids.clone()
        ids[0, -1] = (ids[0, -1] + 1) % 20000
        while bool((ids[0, :-1] == ids[0, -1]).any()):
            ids[0, -1] = (ids[0, -1] + 1) % 20000
        return scores, ids


class DroppedRows:
    """Leaves every 100th stored row out of the scan: its scale reads 0
    while the index answers, and is put back between requests."""

    def __init__(self, index):
        self.index = index
        self.name = ("_leaf_scales" if hasattr(index, "_leaf_scales")
                     else "_scales")

    def __call__(self, queries, k):
        kept = getattr(self.index, self.name)
        dropped = kept.clone()
        dropped.view(-1)[::100] = 0.0
        setattr(self.index, self.name, dropped)
        try:
            return self.index(queries, k)
        finally:
            setattr(self.index, self.name, kept)


class HalfProbes:
    """A ScaNN index that probes half of its leaves."""

    def __init__(self, index):
        self.index = index
        index._num_probes //= 2

    def __call__(self, queries, k):
        return self.index(queries, k)


class WrongLeaves:
    """A ScaNN partition whose centroids no longer match their leaves:
    the rows sit in the wrong leaves, and the reference, which follows
    the partition the index built, follows it too."""

    def __init__(self, index):
        self.index = index
        index._centroids = torch.roll(index._centroids, 1, dims=0)

    def __call__(self, queries, k):
        return self.index(queries, k)


def every(config: dict) -> bool:
    return True


def scann(config: dict) -> bool:
    return config["index"] == "ScaNN"


FAULTS = ((Stale, every), (HalfBatch, every), (Altered, every),
          (DroppedRows, every), (HalfProbes, scann), (WrongLeaves, scann))


def control(config: str, sizes: dict, device: torch.device) -> list:
    """`control.py`'s readings of the configuration's cells on seeds 1
    and 2, each served for 0.2 s."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = control_program.main(["--config", config, "--seeds", "1", "2",
                                   "--seconds", "0.2"], device=device,
                                  sizes=sizes)
    if rc != 0:
        raise RuntimeError(f"control.py exited {rc} for {config}")
    return [json.loads(line) for line in out.getvalue().splitlines()]
