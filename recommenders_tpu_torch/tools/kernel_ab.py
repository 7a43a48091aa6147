#!/usr/bin/env python3
"""Times one kernel of the port under two settings on one NVIDIA GPU, the
settings in turn, so that both readings share the card and its clock.

    python3 recommenders_tpu_torch/tools/kernel_ab.py k2-parts \
        [--blocks-per-sm 2 4 4 2]
    python3 recommenders_tpu_torch/tools/kernel_ab.py k3-f32 [--root DIR]

`k2-parts`: K2's fwd, dq and dc (`csrc/fused_retrieval.cu`) at `bench.py`'s
shape (B = C = 4096, D = 64, bf16 scores, with temperature, log-q,
accidental hits and weights, as `chip_smoke.py` draws them), by CUDA-graph
replay, with `fused_retrieval._BLOCKS_PER_SM` set to each value of
`--blocks-per-sm` in turn.

`k3-f32`: the f32 body of K3 (`csrc/bucketed_scores.cu`) at the serving
smoke's shape (1024 queries, 1,000,000 rows padded to 1,001,472, D = 128,
2048 buckets), the mean of 10 calls between CUDA events, 3 times.
It imports the port from the checkout `--root` (this one by default), so
that two checkouts are compared by running it once for each, in turn:
parent, change, change, parent.

Each prints the card's name and power limit, a line a reading, and last a
JSON object of the readings. Without CUDA it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
SEED = 0
READS = 3


def k2_parts(cs, values) -> dict:
    from recommenders_tpu_torch.ops import fused_retrieval

    size = cs.TrainSize()
    device = torch.device("cuda")
    q, cand, kw = cs.k2_inputs(size, device, SEED)
    qb = q.to(torch.bfloat16).contiguous()
    cb = cand.to(torch.bfloat16).contiguous()
    logq = torch.log(torch.clamp(kw["candidate_sampling_probability"],
                                 1e-6, 1.0)).float().contiguous()
    ids = kw["candidate_ids"].to(torch.int32).contiguous()
    w = kw["sample_weight"].float().contiguous()
    config = (1.0 / cs.K2_TEMPERATURE, True)
    sms = cs.cuda_build.sm_count(device)
    readings = []
    for value in values:
        fused_retrieval._BLOCKS_PER_SM = value
        lse, _ = fused_retrieval.forward_kernel(qb, cb, logq, ids, config)
        kernels = {
            "fwd": lambda: fused_retrieval.forward_kernel(
                qb, cb, logq, ids, config),
            "dq": lambda: fused_retrieval.backward_kernel(
                "dq", qb, cb, logq, ids, w, lse, config),
            "dc": lambda: fused_retrieval.backward_kernel(
                "dc", qb, cb, logq, ids, w, lse, config),
        }
        ms = {name: cs.graph_ms(fn, device) for name, fn in kernels.items()}
        parts = fused_retrieval._parts(size.batch, size.batch, sms)
        readings.append({"blocks_per_sm": value, "parts": parts, "ms": ms})
        print(f"  K2 blocks/SM {value} ({parts} parts): fwd {ms['fwd']:.4f}"
              f" dq {ms['dq']:.4f} dc {ms['dc']:.4f} ms (graph replay)",
              flush=True)
    return {"k2_parts": readings}


def k3_f32(cs) -> dict:
    from recommenders_tpu_torch.ops import scoring

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)
    n, valid = 1_001_472, 1_000_000
    q = torch.randn(1024, cs.DIM, device=device, generator=gen)
    corpus = torch.randn(n, cs.DIM, device=device, generator=gen)
    kw = dict(buckets=2048, chunk=2048, query_tile=256, valid_rows=valid)
    ms = [cs.device_ms(lambda: scoring.bucketed_scores(q, corpus, None,
                                                       **kw),
                       device, iters=10) for _ in range(READS)]
    print(f"  K3 f32 ({cs.__file__}): " + " / ".join(f"{t:.3f}" for t in ms)
          + " ms", flush=True)
    return {"k3_f32_ms": ms}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("what", choices=("k2-parts", "k3-f32"))
    parser.add_argument("--root", type=Path, default=ROOT)
    parser.add_argument("--blocks-per-sm", type=int, nargs="+",
                        default=[2, 4, 4, 2])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    import chip_smoke as cs  # the checkout's, with its package

    print(cs.nvidia_smi(), flush=True)
    cs.cuda_build.build()
    if args.what == "k2-parts":
        result = k2_parts(cs, args.blocks_per_sm)
    else:
        result = k3_f32(cs)
    print(json.dumps(dict(result, root=str(args.root))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
