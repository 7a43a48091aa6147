"""Efficient serving: exact vs approximate retrieval indexes.

Port of `examples/efficient_serving.py` (the counterpart of
`docs/examples/efficient_serving.ipynb`, ScaNN): compare BruteForce, the
bucketed scoring kernel (K3, `csrc/bucketed_scores.cu`) and the
partitioned ScaNN-style index (int8 leaves scored by K4,
`csrc/leaf_scoring.cu`, then an exact reorder) on latency and recall
over a synthetic clustered corpus (partitioned ANN needs cluster
structure: on i.i.d. noise its recall collapses by construction, as for
any ANN).

The default configuration is the JAX example's gate size (50,000 rows);
`RTPU_FULL=1` runs the flagship 200,000 x 128 corpus with 200 leaves, 20
searched. Each index is timed as one warm call, then the mean of 3, each
ending in `torch.cuda.synchronize`, on the card named in the first line.

    python -m recommenders_tpu_torch.examples.efficient_serving [--device cpu]
"""

import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from recommenders_tpu_torch.examples import parse_args
from recommenders_tpu_torch.layers import approximate, factorized_top_k
from recommenders_tpu_torch.utils import device as device_lib

FULL = os.environ.get("RTPU_FULL") == "1"


def card(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi` prints them."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(device)}, power limit not read"


def timed(fn, *args, device: torch.device, iters: int = 3):
    """(mean seconds of `iters` calls after one warm call, last output);
    every call ends in a device synchronize."""
    def call():
        out = fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    out = call()
    start = time.perf_counter()
    for _ in range(iters):
        out = call()
    return (time.perf_counter() - start) / iters, out


def recall(exact_ids, got_ids):
    k = exact_ids.shape[1]
    return float(
        np.mean(
            [
                len(np.intersect1d(exact_ids[i], got_ids[i])) / k
                for i in range(exact_ids.shape[0])
            ]
        )
    )


def clustered_corpus(rng, n, dim, centers=100):
    """Cluster-structured embeddings (what trained towers produce)."""
    c = rng.normal(size=(centers, dim)).astype(np.float32)
    assign = rng.randint(0, centers, n)
    return c[assign] + 0.3 * rng.normal(size=(n, dim)).astype(np.float32)


def build_indexes(k: int, num_leaves: int, num_leaves_to_search: int,
                  device) -> dict:
    """The three indexes, unbuilt."""
    return {
        "brute": factorized_top_k.BruteForce(k=k, device=device),
        "bucketed": factorized_top_k.Bucketed(k=k, device=device),
        "scann": approximate.ScaNN(
            k=k,
            num_leaves=num_leaves,
            num_leaves_to_search=num_leaves_to_search,
            quantize=True,
            num_reordering_candidates=5 * k,
            device=device,
        ),
    }


def main(
    corpus_size: Optional[int] = None,
    dim: int = 128,
    k: int = 10,
    device="cuda",
    full: bool = FULL,
    keep: Optional[dict] = None,
):
    """Prints and returns each index's ms and recall@k. `corpus_size`
    defaults to 200,000 with `full` (the `RTPU_FULL=1` flagship), else
    50,000. A `keep` dict receives the built indexes and the queries."""
    device = device_lib.resolve(device)
    if corpus_size is None:
        corpus_size = 200_000 if full else 50_000
    rng = np.random.RandomState(0)
    corpus = torch.from_numpy(
        clustered_corpus(rng, corpus_size, dim)).to(device)
    queries = torch.from_numpy(
        rng.normal(size=(256, dim)).astype(np.float32)).to(device)
    on = card(device)
    indexes = build_indexes(k, 200 if full else 100, 20 if full else 10,
                            device)

    brute = indexes["brute"].index(corpus)
    t_brute, (_, exact_ids) = timed(brute, queries, device=device)
    exact_ids = exact_ids.cpu().numpy()
    print(f"BruteForce:        {t_brute * 1e3:7.2f} ms  recall=1.000  "
          f"({on})")

    bucketed = indexes["bucketed"].index(corpus)
    t_bucket, (_, ids) = timed(bucketed, queries, device=device)
    r_bucket = recall(exact_ids, ids.cpu().numpy())
    print(
        f"Bucketed (K3):     {t_bucket * 1e3:7.2f} ms  "
        f"recall={r_bucket:.3f}  ({on})"
    )

    scann = indexes["scann"].index(corpus)
    t_scann, (_, ids) = timed(scann, queries, device=device)
    r_scann = recall(exact_ids, ids.cpu().numpy())
    print(
        f"ScaNN-style:       {t_scann * 1e3:7.2f} ms  "
        f"recall={r_scann:.3f}  ({on})"
    )
    if keep is not None:
        keep.update(indexes=indexes, queries=queries)
    return {
        "corpus_size": corpus_size,
        "dim": dim,
        "k": k,
        "buckets": bucketed._buckets,
        "card": on,
        "brute_force_ms": t_brute * 1e3,
        "bucketed_ms": t_bucket * 1e3,
        "scann_ms": t_scann * 1e3,
        "bucketed_recall": r_bucket,
        "scann_recall": r_scann,
        "brute_force_ids": exact_ids,
    }


if __name__ == "__main__":
    main(device=parse_args().device)
