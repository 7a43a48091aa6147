#!/usr/bin/env python3
"""Reads the ranking slice's card-vs-CPU parity at several seeds on one
NVIDIA GPU: the readings that `chip_smoke.py`'s group limits
(`RANKING_GAP`, `HYBRID_GAP`, `MULTITASK_GAP`) are set from.

    python3 recommenders_tpu_torch/tools/parity_seeds.py 0 1 2

For each seed it runs `chip_smoke.py`'s phase 25 (the prebuilt Ranking
model, dot and DCN), phase 26 (the hybrid DLRM: its training, whose
state the parity starts from, then the parity) and phase 27 (`Multitask`
fit and parity), all at full size, each printing its gaps by parameter
group, the planted faults' gaps and the relu flips. A check that fails
is printed and counted instead of ending the run, so every seed is
read; the exit code is 1 if any failed.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def load():
    """This checkout's `chip_smoke.py`."""
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("seeds", type=int, nargs="+")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("parity_seeds: no CUDA device", file=sys.stderr)
        return 1
    cs = load()
    failed = []

    def record(ok: bool, message: str) -> None:
        if not ok:
            failed.append(message)
            print(f"  CHECK FAILED: {message}", flush=True)

    cs.check = record
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(cs.nvidia_smi(), flush=True)
    cs.cuda_build.build()
    size = cs.RankingSize()
    for seed in args.seeds:
        print(f"seed {seed}", flush=True)
        cs.ranking_parity(device, size, seed)
        cs.hybrid(device, size, seed)
        cs.multitask(device, size, seed)
    print(f"{len(failed)} check(s) failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
