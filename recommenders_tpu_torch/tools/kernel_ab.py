#!/usr/bin/env python3
"""Times one kernel of the port under two settings on one NVIDIA GPU, the
settings in turn, so that both readings share the card and its clock.

    python3 recommenders_tpu_torch/tools/kernel_ab.py k2-parts \
        [--f32] [--blocks-per-sm 2 4 4 2]
    python3 recommenders_tpu_torch/tools/kernel_ab.py k2-f32 [--root DIR]
    python3 recommenders_tpu_torch/tools/kernel_ab.py k3-f32 [--root DIR]
    python3 recommenders_tpu_torch/tools/kernel_ab.py k1 [--root DIR]
    python3 recommenders_tpu_torch/tools/kernel_ab.py leaf [--root DIR]
    python3 recommenders_tpu_torch/tools/kernel_ab.py k5-splits \
        [--blocks-per-sm 3 6 12 24 48]

`k2-parts`: K2's fwd, dq and dc (`csrc/fused_retrieval.cu`) at `bench.py`'s
shape (B = C = 4096, D = 64, bf16 scores, with temperature, log-q,
accidental hits and weights, as `chip_smoke.py` draws them), by CUDA-graph
replay, with `fused_retrieval._BLOCKS_PER_SM` set to each value of
`--blocks-per-sm` in turn, and restored after; with `--f32`, f32 scores
and `_F32_BLOCKS_PER_SM` (a fraction may be given: the f32 rule rounds
the parts down).

`k2-f32`: K2's fwd, dq and dc with f32 scores (the multitask path's
bodies) at the same shape and knobs, each by CUDA-graph replay (20 calls
captured, 5 replays), 3 times.

`k3-f32`: the f32 body of K3 (`csrc/bucketed_scores.cu`) at the serving
smoke's shape (1024 queries, 1,000,000 rows padded to 1,001,472, D = 128,
2048 buckets), the mean of 10 calls between CUDA events, 3 times, and the
device time of one call by CUDA-graph replay (10 calls captured, 3
replays).

`k1`: K1 (`csrc/sparse_apply.cu`) as the training step runs it, adagrad on
a bf16 table and bf16 slot with stochastic rounding, at `chip_smoke.py`'s
training shape (V = 131,072, D = 64, n = 4,096 sorted ids with duplicates
and padding, drawn as its K1 check draws them) and on one run of 32 ids
(the launch floor), each by CUDA-graph replay (20 calls captured, 5
replays) and as eager wrapper calls (the mean of 50 between CUDA events),
3 times.

`leaf`: K4 and K5 (`csrc/leaf_scoring.cu`), each format, at
`chip_smoke.py`'s ScaNN shapes: its clustered 1M x 128 corpus and first
request from the seed, its six indexes built on the device, each kernel
called on the served chunk by `chip_smoke.leaf_call`, as phase 16 calls
it (the f32 bodies on the bf16 indexes' leaves cast to f32); the mean of
10 wrapper calls between CUDA events, 3 times a format, and the device
time of one call by CUDA-graph replay (10 calls captured, 3 replays).

`k5-splits`: K5's bf16, int8 and int4 bodies as `leaf` calls them, by
CUDA-graph replay, with `leaf_scoring._K5_BLOCKS_PER_SM` (the blocks an
SM its probe-walk split aims for) set to each value of `--blocks-per-sm`
in turn, and restored after.

`k2-f32`, `k3-f32`, `k1` and `leaf` import the port's package from the
checkout `--root` (this one by default) and set up and time it with this
checkout's `chip_smoke.py`, so that two checkouts are compared by the
same code, running the mode once for each, in turn: parent, change,
change, parent.

Each prints the card's name and power limit, a line a reading, and last a
JSON object of the readings. Without CUDA it exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
SEED = 0
READS = 3


def k2_calls(cs, device: torch.device, bf16: bool) -> dict:
    """K2's fwd, dq and dc calls at `bench.py`'s shape, on the operands
    `chip_smoke.check_k2` times them on (bf16 or f32 scores)."""
    from recommenders_tpu_torch.ops import fused_retrieval

    q, cand, kw = cs.k2_inputs(cs.TrainSize(), device, SEED)
    dtype = torch.bfloat16 if bf16 else torch.float32
    q_op = q.to(dtype).contiguous()
    c_op = cand.to(dtype).contiguous()
    logq = torch.log(torch.clamp(kw["candidate_sampling_probability"],
                                 1e-6, 1.0)).float().contiguous()
    ids = kw["candidate_ids"].to(torch.int32).contiguous()
    w = kw["sample_weight"].float().contiguous()
    config = (1.0 / cs.K2_TEMPERATURE, bf16)
    lse, _ = fused_retrieval.forward_kernel(q_op, c_op, logq, ids, config)
    return {
        "fwd": lambda: fused_retrieval.forward_kernel(
            q_op, c_op, logq, ids, config),
        "dq": lambda: fused_retrieval.backward_kernel(
            "dq", q_op, c_op, logq, ids, w, lse, config),
        "dc": lambda: fused_retrieval.backward_kernel(
            "dc", q_op, c_op, logq, ids, w, lse, config),
    }


def k2_parts(cs, values, bf16: bool = True) -> dict:
    from recommenders_tpu_torch.ops import fused_retrieval

    size = cs.TrainSize()
    device = torch.device("cuda")
    kernels = k2_calls(cs, device, bf16)
    sms = cs.cuda_build.sm_count(device)
    knob = "_BLOCKS_PER_SM" if bf16 else "_F32_BLOCKS_PER_SM"
    default = getattr(fused_retrieval, knob)
    label = "bf16" if bf16 else "f32"
    readings = []
    try:
        for value in values:
            setattr(fused_retrieval, knob, int(value) if bf16 else value)
            ms = {name: cs.graph_ms(fn, device)
                  for name, fn in kernels.items()}
            parts = (fused_retrieval._parts(size.batch, size.batch, sms)
                     if bf16 else fused_retrieval._f32_parts(
                         "fwd", size.batch, size.batch, size.dim, device))
            readings.append({"blocks_per_sm": value, "parts": parts,
                             "ms": ms})
            print(f"  K2 {label} blocks/SM {value} ({parts} parts): fwd "
                  f"{ms['fwd']:.4f} dq {ms['dq']:.4f} dc {ms['dc']:.4f} ms "
                  "(graph replay)", flush=True)
    finally:
        setattr(fused_retrieval, knob, default)
    return {"k2_parts": readings, "scores": label}


def k2_f32(cs) -> dict:
    device = torch.device("cuda")
    readings = {}
    for name, fn in k2_calls(cs, device, bf16=False).items():
        readings[name] = [cs.graph_ms(fn, device) for _ in range(READS)]
        print(f"  K2 f32 {name}: "
              + " / ".join(f"{t:.4f}" for t in readings[name])
              + " ms (graph replay)", flush=True)
    return {"k2_f32_ms": readings}


def k3_f32(cs) -> dict:
    from recommenders_tpu_torch.ops import scoring

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)
    n, valid = 1_001_472, 1_000_000
    q = torch.randn(1024, cs.DIM, device=device, generator=gen)
    corpus = torch.randn(n, cs.DIM, device=device, generator=gen)
    kw = dict(buckets=2048, chunk=2048, query_tile=256, valid_rows=valid)

    def call():
        return scoring.bucketed_scores(q, corpus, None, **kw)

    ms = [cs.device_ms(call, device, iters=10) for _ in range(READS)]
    graph = cs.graph_ms(call, device, launches=10, replays=3)
    print("  K3 f32: " + " / ".join(f"{t:.3f}" for t in ms)
          + f" ms; graph replay {graph:.3f} ms", flush=True)
    return {"k3_f32_ms": ms, "k3_f32_graph_ms": graph}


def k1(cs, device: torch.device, size=None) -> dict:
    size = size or cs.TrainSize()
    spec = cs.emb_config.OptimizerSpec(kind="adagrad", learning_rate=0.05)
    _, scalars, rule, _ = cs.sparse_optimizer._kernel_rule(spec, 7)
    states, ids, grads = cs.k1_problem("adagrad", torch.bfloat16, size.items,
                                       size.dim, size.batch, device, SEED)
    step, floor = cs.k1_calls(states, ids, grads, rule, scalars)
    readings = {}
    for name, fn in (("step", step), ("floor", floor)):
        graph = [cs.graph_ms(fn, device) for _ in range(READS)]
        calls = [cs.device_ms(fn, device, iters=50) for _ in range(READS)]
        readings[name] = {"graph_ms": graph, "call_ms": calls}
        print(f"  K1 {name}: graph replay "
              + " / ".join(f"{t:.5f}" for t in graph) + " ms; calls "
              + " / ".join(f"{t:.5f}" for t in calls) + " ms", flush=True)
    return {"k1": readings}


def leaf_calls(cs, device: torch.device, size=None):
    """Yields (kernel, format, index name, call) for K4 and K5 in every
    format on `chip_smoke.py`'s ScaNN indexes: the calls phase 16 times
    (`chip_smoke.leaf_call`)."""
    size = size or cs.ScannSize(requests=1)
    corpus_np, requests_np = cs.clustered_data(size, SEED)
    corpus = torch.from_numpy(corpus_np).to(device)
    request = torch.from_numpy(requests_np[0]).to(device)
    del corpus_np, requests_np
    for name, (settings, kernel, fmt) in cs.scann_configs(size).items():
        index = cs.approximate.ScaNN(k=cs.K, device=device,
                                     **settings).index(corpus)
        chunk = request[:settings["query_batch"]]
        for f in (fmt, "f32") if fmt == "bf16" else (fmt,):
            yield kernel, f, name, cs.leaf_call(index, kernel, f, chunk)
        del index


def leaf(cs, device: torch.device, size=None) -> dict:
    readings = {}
    for kernel, f, name, fn in leaf_calls(cs, device, size):
        ms = [cs.device_ms(fn, device, iters=10) for _ in range(READS)]
        graph = cs.graph_ms(fn, device, launches=10, replays=3)
        readings[f"{kernel} {f}"] = {"call_ms": ms, "graph_ms": graph}
        print(f"  {kernel} {f} ({name}): calls "
              + " / ".join(f"{t:.4f}" for t in ms)
              + f" ms; graph replay {graph:.4f} ms", flush=True)
    return {"leaf_ms": readings}


def k5_splits(cs, device: torch.device, values, size=None) -> dict:
    leaf_scoring = cs.leaf_scoring
    default = leaf_scoring._K5_BLOCKS_PER_SM
    readings = {}
    try:
        for kernel, f, name, fn in leaf_calls(cs, device, size):
            if kernel != "K5" or f == "f32":
                continue
            for value in values:
                leaf_scoring._K5_BLOCKS_PER_SM = value
                ms = cs.graph_ms(fn, device, launches=10, replays=3)
                readings.setdefault(f"K5 {f}", []).append(
                    {"blocks_per_sm": value, "ms": ms})
                print(f"  K5 {f} ({name}) blocks/SM {value}: {ms:.4f} ms "
                      "(graph replay)", flush=True)
    finally:
        leaf_scoring._K5_BLOCKS_PER_SM = default
    return {"k5_splits": readings}


def load(root: Path):
    """This checkout's `chip_smoke.py` over the port's package from
    `root`: the package is imported first, so the script's own imports
    find it, and both checkouts are set up and timed by the same code."""
    sys.path.insert(0, str(root.resolve()))
    import recommenders_tpu_torch  # noqa: F401  (root's package)

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("what",
                        choices=("k2-parts", "k2-f32", "k3-f32", "k1",
                                 "leaf", "k5-splits"))
    parser.add_argument("--root", type=Path, default=ROOT)
    parser.add_argument("--blocks-per-sm", type=float, nargs="+")
    parser.add_argument("--f32", action="store_true",
                        help="k2-parts: f32 scores")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    cs = load(args.root)
    print(cs.nvidia_smi(), flush=True)
    print(f"package: {Path(cs.leaf_scoring.__file__).parents[1]}",
          flush=True)
    cs.cuda_build.build()
    device = torch.device("cuda")
    if args.what == "k2-parts":
        result = k2_parts(cs, args.blocks_per_sm or [2, 4, 4, 2],
                          bf16=not args.f32)
    elif args.what == "k2-f32":
        result = k2_f32(cs)
    elif args.what == "k3-f32":
        result = k3_f32(cs)
    elif args.what == "k1":
        result = k1(cs, device)
    elif args.what == "leaf":
        result = leaf(cs, device)
    else:
        result = k5_splits(cs, device, [int(v) for v in args.blocks_per_sm
                                        or [3, 6, 12, 24, 48]])
    print(json.dumps(dict(result, root=str(args.root))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
