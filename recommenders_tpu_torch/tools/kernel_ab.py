#!/usr/bin/env python3
"""Times one kernel of the port under two settings on one NVIDIA GPU, the
settings in turn, so that both readings share the card and its clock.

    python3 recommenders_tpu_torch/tools/kernel_ab.py k2-parts \
        [--f32] [--blocks-per-sm 2 4 4 2]
    python3 recommenders_tpu_torch/tools/kernel_ab.py k2-f32 [--root DIR]
    python3 recommenders_tpu_torch/tools/kernel_ab.py k3-f32 [--root DIR]
    python3 recommenders_tpu_torch/tools/kernel_ab.py k3 [--root DIR]
    python3 recommenders_tpu_torch/tools/kernel_ab.py k1 [--root DIR]
    python3 recommenders_tpu_torch/tools/kernel_ab.py leaf [--root DIR]
    python3 recommenders_tpu_torch/tools/kernel_ab.py scale [--root DIR]
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

`k3`: K3 in each format (f32, bf16, int8, int4) on the serving smoke's
indexes (`chip_smoke.BUCKETED` over its 1M x 128 corpus and first
request, from the seed), called as phase 7 calls it: the mean of 10
wrapper calls between CUDA events, 3 times a format, and the device time
of one call by CUDA-graph replay (10 calls captured, 3 replays).

`k1`: K1 (`csrc/sparse_apply.cu`) as the training step runs it, adagrad on
a bf16 table and bf16 slot with stochastic rounding, at `chip_smoke.py`'s
training shape (V = 131,072, D = 64, n = 4,096 sorted ids with duplicates
and padding, drawn as its K1 check draws them) and on one run of 32 ids
(the launch floor), each by CUDA-graph replay (20 calls captured, 5
replays) and as eager wrapper calls (the mean of 50 between CUDA events),
3 times.

`leaf`: K4 and K5 (`csrc/leaf_scoring.cu`), each format, at
`chip_smoke.py`'s ScaNN shapes: its clustered 1M x 128 corpus and first
request from the seed, its eight indexes built on the device, each
kernel called on the served chunk by `chip_smoke.leaf_call`, as phase 16
calls it (each format on the leaves of the index that serves it: the f32
bodies on `f32_gather`'s and `f32_bucketed`'s own f32 rows); the mean of
10 wrapper calls between CUDA events, 3 times a format, and the device
time of one call by CUDA-graph replay (10 calls captured, 3 replays).

`scale`: the int8 bodies of K3 and K5 at the 100M catalog's request
(`chip_smoke.py` phase 38: its streamed 100M x 128 corpus from the seed,
Bucketed int8 and ScaNN int8 built once through `index_streamed`, the
256 fixed queries, K5 on the index's own probe lists) and at the 1M
serving smoke's (phase 7's Bucketed int8, phase 16's `int8_bucketed`
ScaNN, their first request): each by CUDA-graph replay (10 calls
captured, 3 replays) and as eager wrapper calls (the mean of 10 between
CUDA events), 3 times; then a sha256 of one K3 call's `vals` and `rows`
at each shape, so two checkouts' runs show whether K3 answers bit for
bit the same, and, where the package counts them, K3's int8 launches by
query tile (the body's instance) and its fast fold's chunks checked and
updated over one 100M call.

`k5-splits`: K5's bf16, int8 and int4 bodies as `leaf` calls them, by
CUDA-graph replay, with `leaf_scoring._K5_BLOCKS_PER_SM` (the blocks an
SM its probe-walk split aims for) set to each value of `--blocks-per-sm`
in turn, and restored after.

`k2-f32`, `k3-f32`, `k3`, `k1`, `leaf` and `scale` import the port's package from the
checkout `--root` (this one by default) and set up and time it with this
checkout's `chip_smoke.py`, so that two checkouts are compared by the
same code, running the mode once for each, in turn: parent, change,
change, parent.

Each prints the card's name and power limit, a line a reading, and last a
JSON object of the readings. Without CUDA it exits non-zero.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Optional

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


def k3(cs, device: torch.device, size=None) -> dict:
    from recommenders_tpu_torch.ops import scoring

    size = size or cs.Size()
    corpus, queries = cs.serving_inputs(size, SEED, device)
    readings = {}
    for fmt, settings in cs.BUCKETED.items():
        index = cs.factorized_top_k.Bucketed(k=cs.K, device=device,
                                             **settings).index(corpus)
        q = queries if index._quantize else queries.to(
            index._candidates.dtype)
        kw = dict(buckets=index._buckets, chunk=index._chunk,
                  query_tile=index._query_tile, valid_rows=size.items,
                  packed4=fmt == "int4")

        def call():
            return scoring.bucketed_scores(q, index._candidates,
                                           index._scales, **kw)

        ms = [cs.device_ms(call, device, iters=10) for _ in range(READS)]
        graph = cs.graph_ms(call, device, launches=10, replays=3)
        readings[f"K3 {fmt}"] = {"call_ms": ms, "graph_ms": graph}
        print(f"  K3 {fmt}: calls " + " / ".join(f"{t:.4f}" for t in ms)
              + f" ms; graph replay {graph:.4f} ms", flush=True)
        del index
    return {"k3_ms": readings}


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
        yield kernel, fmt, name, cs.leaf_call(index, kernel, chunk)
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


def _reads(cs, name: str, fn, device: torch.device) -> dict:
    graph = [cs.graph_ms(fn, device, launches=10, replays=3)
             for _ in range(READS)]
    calls = [cs.device_ms(fn, device, iters=10) for _ in range(READS)]
    print(f"  {name}: graph replay " + " / ".join(f"{t:.3f}" for t in graph)
          + " ms; calls " + " / ".join(f"{t:.3f}" for t in calls) + " ms",
          flush=True)
    return {"graph_ms": graph, "call_ms": calls}


def _digest(name: str, fn) -> str:
    """A digest of one call's outputs (K3's `vals` and `rows`), so two
    checkouts' runs show whether they answer bit for bit the same."""
    h = hashlib.sha256()
    for t in fn():
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    print(f"  {name}: outputs sha256 {h.hexdigest()[:16]}", flush=True)
    return h.hexdigest()


def _int8_tiles(cs) -> Optional[dict]:
    """K3 int8 launches by query tile, where the package counts them."""
    by = getattr(cs.scoring.bucketed_scores, "launches_by_int8_tile", None)
    print(f"  K3 int8 launches by query tile: {by}", flush=True)
    return None if by is None else {str(k): v for k, v in by.items()}


def _fold_counts(cs, name: str, fn) -> Optional[dict]:
    """K3's fast-fold counts over one call, where the package has them."""
    counts = getattr(cs.cuda_build, "k3_fold_counts", None)
    if counts is None:
        return None
    counts(reset=True)
    fn()
    got = counts(reset=True)
    share = got["updated"] / max(got["checked"], 1)
    print(f"  {name}: fast fold checked {got['checked']} chunks, updated "
          f"{got['updated']} ({share:.4f})", flush=True)
    return got


def scale(cs, device: torch.device) -> dict:
    size = cs.ScaleSize()
    readings = {}
    # 1M: phase 7's Bucketed int8 and phase 16's int8_bucketed ScaNN.
    serving = cs.Size()
    corpus, queries = cs.serving_inputs(serving, SEED, device)
    index = cs.factorized_top_k.Bucketed(
        k=cs.K, device=device, **cs.BUCKETED["int8"]).index(corpus)
    kw = dict(buckets=index._buckets, chunk=index._chunk,
              query_tile=index._query_tile, valid_rows=serving.items)
    k3 = functools.partial(cs.scoring.bucketed_scores, queries,
                           index._candidates, index._scales, **kw)
    readings["K3 int8 1M"] = _reads(cs, "K3 int8 1M", k3, device)
    readings["K3 int8 1M"]["sha256"] = _digest("K3 int8 1M", k3)
    del k3, index, corpus, queries
    scann_size = cs.ScannSize(requests=1)
    corpus_np, requests_np = cs.clustered_data(scann_size, SEED)
    settings = cs.scann_configs(scann_size)[cs.MAIN_INDEX][0]
    index = cs.approximate.ScaNN(k=cs.K, device=device, **settings).index(
        torch.from_numpy(corpus_np).to(device))
    request = torch.from_numpy(requests_np[0][:settings["query_batch"]])
    call = cs.leaf_call(index, "K5", request.to(device))
    readings["K5 int8 1M"] = _reads(cs, "K5 int8 1M", call, device)
    del index, call, corpus_np, requests_np
    cs.release(device)
    # 100M: phase 38's indexes over the streamed catalog.
    batches, draw = cs.scale_stream(size, SEED, device)
    queries = draw(size.queries, cs.SCALE_QUERY_SALT)
    index = cs.approximate.ScaNN(k=cs.K, device=device,
                                 **cs.scale_scann_settings(size))
    index.index_streamed(batches, num_rows=size.rows)
    call = cs.leaf_call(index, "K5", queries)
    readings["K5 int8 100M"] = _reads(cs, "K5 int8 100M", call, device)
    del index, call
    cs.release(device)
    index = cs.factorized_top_k.Bucketed(
        k=cs.K, buckets=size.buckets, chunk=size.chunk,
        query_tile=size.query_tile, quantize="int8",
        device=device).index_streamed(batches, num_rows=size.rows)
    k3 = functools.partial(
        cs.scoring.bucketed_scores, queries, index._candidates,
        index._scales, buckets=index._buckets, chunk=index._chunk,
        query_tile=index._query_tile, valid_rows=index._num_candidates)
    readings["K3 int8 100M"] = _reads(cs, "K3 int8 100M", k3, device)
    readings["K3 int8 100M"]["sha256"] = _digest("K3 int8 100M", k3)
    readings["K3 int8 100M"]["fold"] = _fold_counts(cs, "K3 int8 100M", k3)
    readings["K3 int8 launches by query tile"] = _int8_tiles(cs)
    return {"scale": readings}


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
                        choices=("k2-parts", "k2-f32", "k3-f32", "k3",
                                 "k1", "leaf", "scale", "k5-splits"))
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
    elif args.what == "k3":
        result = k3(cs, device)
    elif args.what == "k1":
        result = k1(cs, device)
    elif args.what == "leaf":
        result = leaf(cs, device)
    elif args.what == "scale":
        result = scale(cs, device)
    else:
        result = k5_splits(cs, device, [int(v) for v in args.blocks_per_sm
                                        or [3, 6, 12, 24, 48]])
    print(json.dumps(dict(result, root=str(args.root))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
