#!/usr/bin/env python3
"""Runs the PyTorch port's retrieval-serving slice on one NVIDIA GPU and
checks it.

    python3 chip_smoke.py [--seed 0] [--requests 3]

The model is one two-tower retrieval model at full width: a query tower
of 65,536 users (embedding 128, MLP (256, 128)) and a candidate tower of
1,000,000 items (embedding 128). Its weights are random, drawn with NumPy
from `--seed` in the flax layout and loaded through `utils.convert`.
Phases, each fatal when it fails:

  1. build every CUDA kernel of the port (`ops/cuda_build.py`);
  2. build the towers;
  3. embed the corpus;
  4. index it five ways (BruteForce, and Bucketed f32, bf16, int8, int4);
  5. serve `--requests` requests of 1024 user ids through every index,
     and one through `query_with_exclusions` with 10 excluded ids a row;
     the kernels' launch counts are zeroed before phase 2 and read right
     after this phase, and every kernel must have launched;
  6. check the served results (shapes, finite descending scores, exact
     scores of the returned ids, the exclusions);
  7. hold each format of the bucketed-scoring kernel against its plain
     PyTorch twin at the served shapes, and time the kernel, the twin and
     the library call that serves the same request exactly;
  8. hold recall@100 of the f32 and bf16 indexes against BruteForce.

It prints the card's name and power limit, one `{"kernels": [...]}` line
and, last, `{"ok": true, "device": {...}}`. Without CUDA, or run outside
a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from recommenders_tpu_torch.layers import factorized_top_k  # noqa: E402
from recommenders_tpu_torch.models import retrieval  # noqa: E402
from recommenders_tpu_torch.ops import cuda_build  # noqa: E402
from recommenders_tpu_torch.ops import quantization  # noqa: E402
from recommenders_tpu_torch.ops import scoring  # noqa: E402
from recommenders_tpu_torch.utils import convert  # noqa: E402

DIM = 128
MLP_UNITS = (256, 128)
K = 100
EXCLUDED = 10
# Queries the plain twin scores at once: its [Q, N] f32 matrix stays
# about 1 GB at N = 1M.
TWIN_QUERIES = 256

# The Bucketed indexes the smoke serves, with their settings.
BUCKETED = {
    "f32": dict(buckets=2048, chunk=2048, query_tile=256),
    "bf16": dict(corpus_dtype=torch.bfloat16, buckets=4096, chunk=4096,
                 query_tile=128),
    "int8": dict(quantize="int8", buckets=4096, chunk=4096),
    "int4": dict(quantize="int4", buckets=2048, chunk=4096),
}
RECALL_FLOORS = {"f32": 0.95, "bf16": 0.97}

SOURCE = "recommenders_tpu_torch/csrc/bucketed_scores.cu"
REPLACES = {
    "f32": "recommenders_tpu/ops/scoring.py:59",
    "bf16": "recommenders_tpu/ops/scoring.py:59",
    "int8": "recommenders_tpu/ops/scoring.py:108",
    "int4": "recommenders_tpu/ops/scoring.py:154",
}

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# operations/s for the type the products are taken in. The quantized
# formats multiply a bf16 query by codes that are exact in bf16.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12, "int8": 989e12,
                  "int4": 989e12}
F32_EPS = 2.0 ** -23


@dataclasses.dataclass(frozen=True)
class Size:
    users: int = 65_536
    items: int = 1_000_000
    batch: int = 1024
    requests: int = 3


def check(ok, message: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {message}")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_ms(fn, device: torch.device, iters: int) -> float:
    """Mean time of `fn()` over `iters` runs after one warm-up, from CUDA
    events around the whole run."""
    fn()
    if device.type != "cuda":
        start = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - start) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def phase(name: str, started: float, detail: str = "") -> None:
    print(f"phase {name}: ok {time.perf_counter() - started:.3f} s"
          + (f" ({detail})" if detail else ""), flush=True)


def flax_params(size: Size, seed: int) -> dict:
    """Random `TwoTowerRetrieval` weights in the flax layout, from NumPy:
    each matrix normal with standard deviation 1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)

    def normal(shape, fan_in):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            fan_in ** -0.5
        )

    widths = (DIM,) + MLP_UNITS
    mlp = {
        f"Dense_{i}": {"kernel": normal((a, b), a),
                       "bias": normal((b,), a) * np.float32(0.1)}
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))
    }
    return {
        "_query": {"Embed_0": {"embedding": normal((size.users, DIM), DIM)},
                   "MLP_0": mlp},
        "_candidate": {
            "Embed_0": {"embedding": normal((size.items, DIM), DIM)}
        },
    }


def numpy_query_tower(params: dict, ids: np.ndarray) -> np.ndarray:
    """The query tower in float64 NumPy, from the flax weights."""
    x = params["_query"]["Embed_0"]["embedding"][np.maximum(ids, 0)]
    x = x.astype(np.float64)
    mlp = params["_query"]["MLP_0"]
    for i in range(len(MLP_UNITS)):
        dense = mlp[f"Dense_{i}"]
        x = x @ dense["kernel"].astype(np.float64) + dense["bias"]
        if i < len(MLP_UNITS) - 1:
            x = np.maximum(x, 0.0)
    return x


def scored_query(index, queries: torch.Tensor) -> torch.Tensor:
    """The queries as the index scores them, in f32: rounded to bf16 for
    a bf16 or quantized index."""
    if index._quantize or index._candidates.dtype == torch.bfloat16:
        return queries.to(torch.bfloat16).to(torch.float32)
    return queries.to(torch.float32)


def stored_rows(index, rows: torch.Tensor):
    """(f32 values, f32 scales) of the index's stored rows `rows`: the
    rows themselves and scales of 1, or the integer codes and their
    per-row scales."""
    rows = rows.long()
    stored = index._candidates
    if index._quantize == "int4":
        stored = quantization.unpack_nibbles(stored)
    values = stored[rows].to(torch.float32)
    if index._scales is None:
        return values, torch.ones(rows.shape, device=rows.device)
    return values, index._scales[rows]


def score_tolerance(index, queries, rows, values):
    """The a-priori bound of an f32 dot over D products taken in another
    order, D·ε·Σ|q||c|·|s|, plus one rounding of the scale multiply."""
    codes, scales = stored_rows(index, rows)
    abs_dot = (scored_query(index, queries).abs()[:, None, :]
               * codes.abs()).sum(-1) * scales.abs()
    return DIM * F32_EPS * abs_dot + 2 * F32_EPS * values.abs()


def stored_bytes(index) -> int:
    """Bytes of the index's stored corpus (rows or codes, and scales)."""
    scales = getattr(index, "_scales", None)
    return index._candidates.nbytes + (0 if scales is None else scales.nbytes)


def reset_counts() -> None:
    scoring.bucketed_scores.launches = 0
    for fmt in scoring.bucketed_scores.launches_by_format:
        scoring.bucketed_scores.launches_by_format[fmt] = 0


def recall(got: torch.Tensor, want: torch.Tensor) -> float:
    hits = (got[:, :, None] == want[:, None, :]).any(-1)
    return float(hits.float().mean())


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def run(device: torch.device, size: Size, seed: int) -> list:
    """Drives the slice on `device`; returns the kernels' report."""
    # 1. Build.
    started = time.perf_counter()
    if device.type == "cuda":
        logs = cuda_build.build()
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  nvcc {name}: {line.strip()}")
    phase("build", started, f"{len(cuda_build.SOURCES)} source(s)")

    reset_counts()
    with torch.no_grad():
        # 2. Towers.
        started = time.perf_counter()
        params = flax_params(size, seed)
        model = retrieval.TwoTowerRetrieval(
            retrieval.EmbeddingTower(size.users, DIM, MLP_UNITS,
                                     device=device),
            retrieval.EmbeddingTower(size.items, DIM, device=device),
        )
        convert.load_flax_params(model, params)
        model.eval().requires_grad_(False)
        probe = np.array([0, 1, size.users - 1, -1, 12345 % size.users])
        got = model.query_embeddings(
            {"user_id": torch.from_numpy(probe).to(device)}
        ).double().cpu().numpy()
        want = numpy_query_tower(params, probe)
        check(np.allclose(got, want, rtol=1e-5, atol=1e-5),
              "query tower disagrees with its NumPy reference")
        del params
        sync(device)
        phase("towers", started, f"{size.users} users, {size.items} items")

        # 3. Embed the corpus.
        started = time.perf_counter()
        corpus = model.candidate_embeddings(
            {"movie_id": torch.arange(size.items, device=device)}
        )
        check(corpus.shape == (size.items, DIM)
              and bool(torch.isfinite(corpus).all()),
              f"corpus embeddings {tuple(corpus.shape)} not finite/shaped")
        sync(device)
        phase("embed", started, f"{tuple(corpus.shape)} f32")

        # 4. Index five ways.
        query_fn = model.query_embeddings
        indexes = {}
        started = time.perf_counter()
        indexes["brute_force"] = factorized_top_k.BruteForce(
            query_fn, k=K, device=device
        ).index(corpus)
        for fmt, settings in BUCKETED.items():
            indexes[fmt] = factorized_top_k.Bucketed(
                query_fn, k=K, device=device, **settings
            ).index(corpus)
        sync(device)
        phase("index", started, ", ".join(
            f"{name} {stored_bytes(index) / 1e6:.1f} MB"
            for name, index in indexes.items()
        ))

        # 5. Serve.
        started = time.perf_counter()
        rng = np.random.default_rng(seed + 1)
        requests = [
            {"user_id": torch.from_numpy(
                rng.integers(0, size.users, size.batch)).to(device)}
            for _ in range(size.requests)
        ]
        results, latency_ms, peak_mb = {}, {}, {}
        for name, index in indexes.items():
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            results[name], latency_ms[name] = [], []
            for request in requests:
                t = time.perf_counter()
                results[name].append(index(request))
                sync(device)
                latency_ms[name].append((time.perf_counter() - t) * 1e3)
            if device.type == "cuda":
                peak_mb[name] = torch.cuda.max_memory_allocated(device) / 1e6
        excluded = results["f32"][0][1][:, 0:2 * EXCLUDED:2]
        _, excl_ids = indexes["f32"].query_with_exclusions(
            requests[0], excluded
        )
        sync(device)
        counts = dict(scoring.bucketed_scores.launches_by_format)
        total = scoring.bucketed_scores.launches
        phase("serve", started, f"launches {counts}")
        for name in indexes:
            lat = sorted(latency_ms[name])
            print(f"  serve {name}: {size.requests} x {size.batch} queries, "
                  f"request ms {[round(x, 3) for x in latency_ms[name]]} "
                  f"(median {lat[len(lat) // 2]:.3f})"
                  + (f", peak device memory {peak_mb[name]:.1f} MB"
                     if name in peak_mb else ""))
        if device.type == "cuda":
            check(total == len(BUCKETED) * size.requests + 1,
                  f"{total} kernel launches, expected one per Bucketed call")
            for fmt in BUCKETED:
                check(counts[fmt] > 0, f"kernel format {fmt} never launched")

        # 6. The served results.
        started = time.perf_counter()
        queries = [query_fn(r) for r in requests]
        for name, index in indexes.items():
            for q, (scores, ids) in zip(queries, results[name]):
                check(scores.shape == (size.batch, K)
                      and ids.shape == (size.batch, K),
                      f"{name}: result shapes {scores.shape}, {ids.shape}")
                check(bool(torch.isfinite(scores).all()),
                      f"{name}: non-finite scores")
                check(bool(((ids >= 0) & (ids < size.items)).all()),
                      f"{name}: ids outside the corpus")
                check(bool((scores[:, :-1] >= scores[:, 1:]).all()),
                      f"{name}: scores not descending")
                sorted_ids = ids.sort(dim=1).values
                check(bool((sorted_ids[:, 1:] != sorted_ids[:, :-1]).all()),
                      f"{name}: an id repeats within a row")
                if name == "brute_force":
                    exact = (q[:, None, :] * corpus[ids.long()]).sum(-1)
                    tol = DIM * F32_EPS * (
                        q.abs()[:, None, :] * corpus[ids.long()].abs()
                    ).sum(-1)
                else:
                    codes, scales = stored_rows(index, ids)
                    exact = (scored_query(index, q)[:, None, :]
                             * codes).sum(-1) * scales
                    tol = score_tolerance(index, q, ids, exact)
                check(bool(((scores - exact).abs() <= tol).all()),
                      f"{name}: returned scores are not the exact dot "
                      f"products of the returned ids")
        _, over_ids = indexes["f32"](requests[0], k=K + EXCLUDED)
        hit = (over_ids[:, :, None] == excluded[:, None, :]).any(-1)
        check(bool((hit.sum(1) == EXCLUDED).all()),
              "over-fetch lost an excluded id")
        kept = over_ids[~hit].view(size.batch, K)
        check(excl_ids.shape == (size.batch, K)
              and not bool((excl_ids[:, :, None]
                            == excluded[:, None, :]).any()),
              "query_with_exclusions returned an excluded id")
        check(torch.equal(kept.sort(1).values, excl_ids.sort(1).values),
              "query_with_exclusions is not the over-fetch minus exclusions")
        phase("outputs", started, "shapes, exact scores, exclusions")

        # 7. Each kernel format against its plain twin, and its times.
        started = time.perf_counter()
        report = []
        q_full = queries[0]
        tower_ms = device_ms(lambda: query_fn(requests[0]), device, iters=10)
        print(f"  query tower: {tower_ms:.3f} ms for {size.batch} queries")
        for fmt in BUCKETED:
            index = indexes[fmt]
            q = q_full if index._quantize else q_full.to(
                index._candidates.dtype
            )
            packed4 = fmt == "int4"
            kw = dict(buckets=index._buckets, chunk=index._chunk,
                      query_tile=index._query_tile, valid_rows=size.items,
                      packed4=packed4)

            def kernel():
                return scoring.bucketed_scores(
                    q, index._candidates, index._scales, **kw
                )

            def twin(sub):
                return scoring.bucketed_scores_reference(
                    sub, index._candidates, index._scales,
                    buckets=kw["buckets"], valid_rows=size.items,
                    packed4=packed4,
                )

            vals, rows = kernel()
            nq = min(TWIN_QUERIES, size.batch)
            twin_vals, twin_rows = twin(q[:nq])
            err = (vals[:nq] - twin_vals).abs()
            tol = score_tolerance(index, q[:nq], twin_rows, twin_vals)
            check(bool((err <= tol).all()),
                  f"kernel {fmt}: scores off the twin by {float(err.max())}")
            # Ids must agree wherever the twin's bucket winner beats its
            # runner-up by more than twice the score tolerance.
            stored = index._candidates
            if packed4:
                stored = quantization.unpack_nibbles(stored)
            table = scoring.reference_scores(
                q[:nq], stored, index._scales, size.items
            ).view(nq, -1, kw["buckets"])
            del stored
            top2 = table.topk(2, dim=1).values
            del table
            separated = (top2[:, 0] - top2[:, 1]) > 2 * tol
            share = float(separated.float().mean())
            check(share >= 0.9,
                  f"kernel {fmt}: only {share:.4f} of buckets separated")
            check(torch.equal(rows[:nq][separated], twin_rows[separated]),
                  f"kernel {fmt}: ids differ from the twin's in a "
                  f"separated bucket")

            ms = device_ms(kernel, device, iters=10)
            plain_ms = device_ms(
                lambda: [twin(q[i:i + nq]) for i in range(0, size.batch, nq)],
                device, iters=3,
            )
            library_ms = library_time(index, q_full, device)
            select_ms = device_ms(lambda: torch.topk(vals, K, dim=1), device,
                                  iters=10)
            q_bytes = q.numel() * (2 if index._quantize else q.element_size())
            in_bytes = q_bytes + stored_bytes(index)
            out_bytes = vals.nbytes + rows.nbytes
            ops = 2.0 * size.batch * size.items * DIM
            bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / PEAK_OPS_PER_S[fmt] * 1e3
            report.append({
                "name": f"bucketed_scores[{fmt}]",
                "route": "cuda",
                "source": SOURCE,
                "replaces": REPLACES[fmt],
                "launches": counts[fmt],
                "max_abs_err": float(err.max()),
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
                "library_ms": library_ms,
                "shape": f"Q={size.batch} N={index._candidates.shape[0]}"
                         f"{'x2' if packed4 else ''} D={DIM} "
                         f"B={kw['buckets']}",
            })
            print(f"  kernel {fmt}: max |err| {float(err.max()):.3g}, ids "
                  f"equal in every separated bucket ({share:.4f} of all "
                  f"buckets); kernel "
                  f"{ms:.3f} ms, twin {plain_ms:.3f} ms, library "
                  f"{library_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.3f} "
                  f"ms; top-{K} over [Q, B] {select_ms:.3f} ms", flush=True)
        phase("kernels", started, "every format held against its twin")

        # 8. Recall@100 against BruteForce.
        started = time.perf_counter()
        exact_ids = [ids for _, ids in results["brute_force"]]
        for fmt in BUCKETED:
            value = float(np.mean([
                recall(ids, want)
                for (_, ids), want in zip(results[fmt], exact_ids)
            ]))
            floor = RECALL_FLOORS.get(fmt)
            print(f"  recall@{K} {fmt}: {value:.4f}"
                  + (f" (floor {floor})" if floor else ""))
            if floor is not None:
                check(value >= floor,
                      f"recall@{K} of {fmt} is {value:.4f} < {floor}")
        phase("recall", started)
    return report


def library_time(index, queries: torch.Tensor, device: torch.device) -> float:
    """Time of the library call that serves the same request exactly
    (the BruteForce path): `torch.matmul` of the queries with the stored
    corpus in its compute type, then `torch.topk`. Integer codes are cast
    to bf16 (exact) before the timing and their scales multiply after."""
    stored, scales = index._candidates, index._scales
    if index._quantize == "int4":
        stored = quantization.unpack_nibbles(stored)
    if index._quantize:
        stored = stored.to(torch.bfloat16)
    q = queries.to(stored.dtype)

    def call():
        scores = torch.matmul(q, stored.T)
        if scales is not None:
            scores = scores * scales
        return torch.topk(scores, K, dim=1)

    return device_ms(call, device, iters=5)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--requests", type=int, default=Size.requests)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: FAILED: CUDA is not available; this smoke runs "
            "only on an NVIDIA GPU"
        )
    # f32 products stay f32 in the twin and the library call (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(nvidia_smi(), flush=True)
    report = run(device, Size(requests=args.requests), args.seed)
    print(f"total {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
