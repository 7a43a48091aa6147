"""What a cell of `runners/ranking_serving.py` has to satisfy, for the
harness's own tests; `contracts/index_serving.py` says what each name
means. The runner's control CLI (`python3 -m
portbench.runners.ranking_serving`) plants the same faults."""

import importlib
import json
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]

NUMBERS = ("logit_gap",)
END_TO_END = ("qps", "request_p95_ms", "setup_s")
CONTROL_FAILS = NUMBERS

_NO_DEVICE = "the CPU runs no kernel: the trace holds no device time"
SILENT_ON_CPU = {
    "pool_roofline": _NO_DEVICE,
    "ranking.mfu": _NO_DEVICE,
    "ranking.dense_ms": _NO_DEVICE,
    "ranking.launches": _NO_DEVICE,
    "ranking.idle_share": _NO_DEVICE,
    "pool.launch_us": "the CPU pools by the kernel's twin and records no "
                      "launch span",
}
SILENT_ON_CARD = {}


def _sparse(batch: dict) -> list:
    return [name for name in batch if name != "dense_features"]


class HalfPairs:
    """Scores the first half of the pairs; the second half gets the first
    half's logits."""

    def __init__(self, model):
        self.model = model

    def __call__(self, batch):
        pairs = batch["dense_features"].shape[0]
        half = -(-pairs // 2)
        logits = self.model.logits({k: v[:half] for k, v in batch.items()})
        return torch.cat([logits, logits])[:pairs]


class DroppedIds:
    """Leaves the last id of every bag out (padding in its place)."""

    def __init__(self, model):
        self.model = model

    def __call__(self, batch):
        out = dict(batch)
        for name in _sparse(batch):
            ids = batch[name].clone()
            ids[:, -1] = -1
            out[name] = ids
        return self.model.logits(out)


class Bf16Table:
    """Stores one table in bf16: the table of the widest bag, converted at
    the first request and kept so."""

    def __init__(self, model):
        self.model = model
        self.done = False

    def __call__(self, batch):
        if not self.done:
            name = max(_sparse(batch), key=lambda n: batch[n].shape[1])
            table = next(fc.table.name for fc in self.model.feature_configs
                         if fc.name == name)
            for pname, param in self.model.embedding.named_parameters():
                if pname.split(".")[-1] == table:
                    param.data = param.data.to(torch.bfloat16)
            self.done = True
        return self.model.logits(batch)


def every(config: dict) -> bool:
    return True


# Bf16Table last: it changes the model it wraps.
FAULTS = ((HalfPairs, every), (DroppedIds, every), (Bf16Table, every))


def control(config: str, sizes: dict, device: torch.device) -> list:
    """The runner's control readings of the configuration's cells on seeds
    1 and 2: the program's, the reference pooling in fp16, and each fault
    (the reference's dense layers in TF32, and `FAULTS` planted)."""
    from portbench.run import merged

    runner = importlib.import_module("portbench.runners.ranking_serving")
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
                {fault.__name__: fault for fault, holds in FAULTS
                 if holds(spec)}):
            out.append(dict(reading, cell=w["name"]))
    return out
