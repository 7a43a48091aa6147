"""A second runner, as small as a runner can be: the pattern a runner
follows, kept for the harness's test that a cell of a new runner comes
in by new files alone (`tests/test_portbench_second_runner.py`).

One client in a closed loop; each request is `pairs` user-item pairs,
an id into an embedding table and `dim` dense features each, answered
with one logit a pair: the id's row dotted with the features. Set-up
draws the table and the request pool from the seed on the device and
warms up the request shape; the window serves the pool in order. Then
a sample of the answers, drawn from the seed, is held against the
reference: the same sums in float64 on a table drawn again from the
seed. `logit_gap` is the widest gap, as a share of the request's
largest reference logit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from portbench import generator
from portbench import tracing

TABLE_SALT = 1 << 44


@dataclasses.dataclass
class Reading:
    """What this runner's per-layer metrics read: the traced window."""
    trace: tracing.Trace


@dataclasses.dataclass
class Outcome:
    end_to_end: dict
    attempted: int
    failed: int
    numbers: dict
    memory_peak_bytes: int
    reading: Optional[Reading] = None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def table(config: dict, seed: int, device: torch.device) -> torch.Tensor:
    return torch.randn((config["rows"], config["dim"]), device=device,
                       generator=generator.generator(seed, TABLE_SALT,
                                                     device))


def requests(config: dict, traffic: dict, seed: int, salt: int,
             count: int, device: torch.device):
    """`count` requests: `[count, pairs]` ids and `[count, pairs, dim]`
    features, in two calls of one generator."""
    gen = generator.generator(seed, salt, device)
    shape = (count, traffic["pairs"])
    ids = torch.randint(0, config["rows"], shape, generator=gen,
                        device=device)
    features = torch.randn(shape + (config["dim"],), generator=gen,
                           device=device)
    return ids, features


class Scorer:
    """The system under test: one logit a pair."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows

    def __call__(self, ids, features):
        return (self.rows[ids] * features).sum(-1)


def logit_gap(got: torch.Tensor, ids, features, rows) -> float:
    want = (rows[ids].double() * features.double()).sum(-1)
    norm = want.abs().max().clamp_min(1e-30)
    gap = ((got.double().to(want.device) - want).abs().max() / norm)
    return float(torch.nan_to_num(gap, nan=float("inf")))


def run(config: dict, traffic: dict, check: dict, seed: int, seconds: float,
        trace: bool, device: torch.device, t0: float,
        wrap: Optional[Callable] = None) -> Outcome:
    scorer = Scorer(table(config, seed, device))
    served = scorer if wrap is None else wrap(scorer)
    ids, features = requests(config, traffic, seed, generator.REQUEST_SALT,
                             traffic["pool_requests"], device)
    for i in range(traffic["warmup_requests"]):
        served(ids[i], features[i]).cpu()
    sync(device)
    setup_s = time.perf_counter() - t0

    latencies, answers = [], []
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=tracing.activities())
        prof.__enter__()
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds:
        now = time.perf_counter()
        j = i % ids.shape[0]
        with torch.profiler.record_function(tracing.REQUEST_SPAN):
            got = served(ids[j], features[j]).cpu()
        latencies.append(time.perf_counter() - now)
        answers.append((j, got))
        i += 1
    window_s = time.perf_counter() - start
    reading = None
    if trace:
        prof.__exit__(None, None, None)
        reading = Reading(tracing.read_profile(prof))

    pairs = traffic["pairs"]
    good = [(j, got) for j, got in answers if tuple(got.shape) == (pairs,)
            and bool(torch.isfinite(got).all())]
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    end_to_end = {"qps": len(good) / window_s,
                  "request_p95_ms": float(np.percentile(latencies, 95) * 1e3),
                  "setup_s": setup_s}
    del scorer, served
    rows = table(config, seed, device)
    pick = np.random.default_rng(seed).permutation(len(good))[
        :check["requests"]]
    gaps = [logit_gap(good[p][1], ids[good[p][0]], features[good[p][0]],
                      rows) for p in pick]
    numbers = {"logit_gap": max(gaps) if gaps else float("inf")}
    return Outcome(end_to_end, len(answers), len(answers) - len(good),
                   numbers, memory_peak, reading)


def control_readings(config: dict, traffic: dict, check: dict, seeds: list,
                     device: torch.device, faults: dict) -> list:
    """The program's, the control's (the table and features in bfloat16)
    and each fault's `logit_gap` on the first `check["requests"]`
    requests of the pool, one dict a seed."""
    out = []
    for seed in seeds:
        rows = table(config, seed, device)
        ids, features = requests(config, traffic, seed,
                                 generator.REQUEST_SALT, check["requests"],
                                 device)
        low = Scorer(rows.bfloat16())

        def gap(score):
            return max(logit_gap(score(ids[r], features[r]), ids[r],
                                 features[r], rows)
                       for r in range(ids.shape[0]))

        out.append({
            "seed": seed,
            "program": {"logit_gap": gap(Scorer(rows))},
            "control": {"logit_gap": gap(
                lambda i, f: low(i, f.bfloat16()).float())},
            "faults": {name: {"logit_gap": gap(fault(Scorer(rows)))}
                       for name, fault in faults.items()}})
    return out
