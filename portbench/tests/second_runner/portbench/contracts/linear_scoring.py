"""What a cell of `runners/linear_scoring.py` has to satisfy, for the
harness's own tests; `contracts/index_serving.py` says what each name
means."""

import importlib
import json
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]

NUMBERS = ("logit_gap",)
END_TO_END = ("qps", "request_p95_ms", "setup_s")
CONTROL_FAILS = NUMBERS
SILENT_ON_CPU = {}
SILENT_ON_CARD = {}


class HalfPairs:
    """Scores the first half of the pairs; the second half gets the
    first half's logits."""

    def __init__(self, scorer):
        self.scorer = scorer

    def __call__(self, ids, features):
        half = ids.shape[0] // 2
        logits = self.scorer(ids[:half], features[:half])
        return torch.cat([logits, logits])


def every(config: dict) -> bool:
    return True


FAULTS = ((HalfPairs, every),)


def control(config: str, sizes: dict, device: torch.device) -> list:
    """The readings of each of the configuration's cells on seeds 1 and
    2: the reference in bfloat16 in the program's place, and each fault
    planted in the program."""
    from portbench.run import merged

    runner = importlib.import_module("portbench.runners.linear_scoring")
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in manifest["configs"]}[config]
    spec = merged(json.loads((BENCH.parent / entry["file"]).read_text()),
                  sizes.get("config", {}))
    out = []
    for w in manifest["workloads"]:
        if w["config"] != config:
            continue
        traffic = merged(json.loads((BENCH / "traffic"
                                     / f"{w['traffic']}.json").read_text()),
                         sizes.get("traffic", {}))
        check = merged(json.loads((BENCH / "workloads"
                                   / f"{w['name']}.json").read_text())[
                                       "check"], sizes.get("check", {}))
        for reading in runner.control_readings(
                spec, traffic, check, [1, 2], device,
                {fault.__name__: fault for fault, _ in FAULTS}):
            out.append(dict(reading, cell=w["name"]))
    return out
