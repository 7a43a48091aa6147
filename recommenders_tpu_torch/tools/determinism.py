"""Are two runs from one seed bit-equal on the card? Before and after the
fixed-order sums.

    python -m recommenders_tpu_torch.tools.determinism [--seed 0]

Two sites of the port sum duplicate rows:

  - `embedding.gather_rows`' backward (every `TpuEmbedding` /
    `PartialEmbedding` / `UnifiedEmbedding` table with dense gradients):
    `index_select`'s own backward adds with `index_add_`, whose CUDA
    kernel adds with atomics in arrival order; the port's backward adds
    through `ops.sparse_apply.fixed_order_index_add_` (a stable sort and
    run-by-run sums on the card);
  - the device k-means' cluster sums (`layers.approximate.
    _kmeans_step_device`), the same two ways.

For each site the tool runs the same work twice with each sum and says
whether the two runs are bit-equal: one unified-embedding arm of
`tools/quality_parity.py` (`--uet-epochs` epochs at its recorded size;
its parameters' bytes and AUC), and one build of `chip_smoke.py`'s main
ScaNN partition over its clustered corpus (centroid and leaf-row bytes).
It prints one JSON line and exits 1 when a fixed-order run is not
bit-equal. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

from recommenders_tpu_torch.embedding import embedding as embedding_lib
from recommenders_tpu_torch.layers import approximate
from recommenders_tpu_torch.ops import sparse_apply
from recommenders_tpu_torch.tools import quality_parity


def _atomic_gather_rows(table, ids):
    """`gather_rows` with `index_select`'s own (atomic) backward."""
    out = torch.index_select(table, 0, torch.clamp(ids.reshape(-1), min=0))
    out = out.view(tuple(ids.shape) + (table.shape[1],))
    return out.masked_fill((ids == embedding_lib.PAD_ID)[..., None], 0.0)


def _atomic_index_add_(out, rows, values):
    return out.index_add_(0, rows, values.to(out.dtype))


@contextlib.contextmanager
def _sums(kind: str):
    """Runs the block with the port's fixed-order sums, or with the
    atomic `index_add_` both sites took before."""
    saved = (embedding_lib.gather_rows, sparse_apply.fixed_order_index_add_)
    if kind == "atomic":
        embedding_lib.gather_rows = _atomic_gather_rows
        sparse_apply.fixed_order_index_add_ = _atomic_index_add_
    try:
        yield
    finally:
        embedding_lib.gather_rows, sparse_apply.fixed_order_index_add_ = (
            saved)


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def unified_arm(args: argparse.Namespace) -> Dict:
    train, test = quality_parity.make_uet(args)
    model = quality_parity.uet_model("unified", args)
    out = quality_parity.train_uet(model, train, test, args)
    return {"auc": float(out["auc"]),
            "params": _digest(p for _, p in sorted(
                model.named_parameters()))}


def scann_partition(device: torch.device, seed: int, items: int) -> Dict:
    """`chip_smoke.py`'s main partition (L = 1,024, 8 Lloyd iterations
    over a 2²¹-row sample) over its clustered corpus
    (`benchmarks/serving.py:339-348`: 1,024 centres at scale 3.0 plus
    unit noise)."""
    rng = np.random.RandomState(seed)
    centers = rng.normal(scale=3.0, size=(1024, 128)).astype(np.float32)
    corpus = (centers[rng.randint(0, 1024, items)]
              + rng.normal(size=(items, 128)).astype(np.float32))
    index = approximate.ScaNN(
        num_leaves=1024, num_leaves_to_search=256, quantize="int8",
        scoring_buckets=4096, probe_tile=64, query_batch=1024,
        kmeans_sample_size=2**21, training_iterations=8, device=device)
    start = time.perf_counter()
    index.index(torch.from_numpy(corpus).to(device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"centroids": _digest([index._centroids]),
            "leaf_rows": _digest([index._leaf_rows]),
            "build_s": time.perf_counter() - start}


def twice(run: Callable[[], Dict]) -> Dict:
    first, second = run(), run()
    same = all(first[k] == second[k] for k in first if k != "build_s")
    return {"bit_equal": same, "runs": [first, second]}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--uet-epochs", type=int, default=2)
    parser.add_argument("--items", type=int, default=1_000_000)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("determinism: FAILED: CUDA is not available")
    device = torch.device("cuda", 0)
    uet_args = quality_parity.parse_args(
        ["--device", str(device), "--uet-epochs", str(args.uet_epochs)])
    result = {"device": torch.cuda.get_device_name(0)}
    for kind in ("atomic", "fixed_order"):
        with _sums(kind):
            result[kind] = {
                "unified_arm": twice(lambda: unified_arm(uet_args)),
                "scann_partition": twice(lambda: scann_partition(
                    device, args.seed, args.items)),
            }
    print(json.dumps(result))
    fixed = result["fixed_order"]
    return 0 if all(v["bit_equal"] for v in fixed.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
