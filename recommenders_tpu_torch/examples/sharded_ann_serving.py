"""Beyond-one-card approximate serving: streamed SHARDED index builds.

Port of `examples/sharded_ann_serving.py`. A corpus too large for any
single device streams batch-by-batch onto its owning ranks
(`ShardedBucketed.index_streamed` / `ShardedScaNN.index_streamed`), and
queries run SPMD with only `k × ranks` rows of cross-rank traffic. The
sharded Bucketed scores each rank's int8 rows with K3
(`csrc/bucketed_scores.cu`); the sharded ScaNN serves its full
production configuration (int8 leaves with the in-kernel bucketed fold
per shard, K5 in `csrc/leaf_scoring.cu`, balanced k-means partitions,
and an exact reorder over the row-sharded corpus). Reference
counterpart: ScaNN serialized into the SavedModel + Streaming's
host-bounded corpus (`tensorflow_recommenders/layers/
factorized_top_k.py:404-509,688-707`); here capacity scales with ranks
instead of host RAM.

One rank a card by default (NCCL); `--ranks N` runs N ranks, sharing the
cards over gloo when there are fewer cards than ranks.

    python -m recommenders_tpu_torch.examples.sharded_ann_serving [--device cpu] [--ranks N]
"""

from typing import Optional

import numpy as np
import torch

from recommenders_tpu_torch.examples import is_first_rank, launch
from recommenders_tpu_torch.examples import parse_args
from recommenders_tpu_torch.layers import approximate, factorized_top_k
from recommenders_tpu_torch.parallel import ann as parallel_ann
from recommenders_tpu_torch.parallel import mesh as mesh_lib

BUCKETED_RECALL_FLOOR = 0.95
SCANN_RECALL_FLOOR = 0.85


def build_indexes(device) -> dict:
    """The two sharded indexes, unbuilt."""
    return {
        # Exact baseline: the Bucketed sweep, also streamed + sharded.
        "bucketed": parallel_ann.ShardedBucketed(
            k=10, buckets=512, chunk=512, quantize="int8", device=device),
        # ScaNN production config: probed int8 leaves, bucketed in-kernel
        # fold, balanced k-means, exact reorder over the row-sharded
        # corpus.
        "scann": parallel_ann.ShardedScaNN(
            approximate.ScaNN(
                k=10,
                num_leaves=64,
                num_leaves_to_search=24,
                quantize="int8",
                scoring_buckets=768,
                probe_tile=8,
                num_reordering_candidates=60,
                kmeans_balance_fraction=0.125,
                training_iterations=8,
                device=device,
            )
        ),
    }


def run(device: torch.device, num_rows: int = 40_000, dim: int = 128,
        batch: int = 4_096, keep: Optional[dict] = None):
    """One rank's body: both indexes over every rank of the default
    group on one model axis. A `keep` dict receives the built indexes
    and the queries."""
    import torch.distributed as dist

    printing = is_first_rank()
    if printing:
        print(f"devices: {dist.get_world_size()}")
    rng = np.random.RandomState(0)
    centers = rng.normal(size=(64, dim)).astype(np.float32)

    # A host-side batch stream stands in for a corpus of embeddings far
    # past one device's memory: each rank keeps only the rows it owns, so
    # the full corpus never exists on any device.
    def corpus_batches():
        r = np.random.RandomState(7)
        for start in range(0, num_rows, batch):
            b = min(batch, num_rows - start)
            a = r.randint(0, 64, b)
            yield (centers[a] + 0.3 * r.normal(size=(b, dim))).astype(
                np.float32
            )

    queries = torch.from_numpy((
        centers[rng.randint(0, 64, 128)]
        + 0.3 * rng.normal(size=(128, dim))
    ).astype(np.float32)).to(device)

    indexes = build_indexes(device)
    bucketed = indexes["bucketed"].index_streamed(corpus_batches, num_rows)
    b_scores, b_ids = bucketed(queries)
    scann = indexes["scann"].index_streamed(corpus_batches, num_rows)
    s_scores, s_ids = scann(queries)

    # Ground truth from an exact single-device scan (small demo corpus).
    full = torch.from_numpy(np.concatenate(list(corpus_batches()), axis=0))
    bf = factorized_top_k.BruteForce(k=10, device=device).index(
        full.to(device))
    _, true_ids = bf(queries)

    def recall(ids):
        ids, truth = ids.cpu().numpy(), true_ids.cpu().numpy()
        return float(np.mean(
            [len(set(ids[i]) & set(truth[i])) / 10 for i in range(128)]
        ))

    n_shards = mesh_lib.axis_size(bucketed._mesh, bucketed._axis)
    b_recall, s_recall = recall(b_ids), recall(s_ids)
    if printing:
        print(
            f"streamed sharded Bucketed over {n_shards} shards: "
            f"recall@10 {b_recall:.3f}"
        )
        print(
            f"streamed sharded ScaNN (probed+fold+reorder): "
            f"recall@10 {s_recall:.3f}"
        )
    if keep is not None:
        keep.update(indexes=indexes, queries=queries)
    assert b_recall > BUCKETED_RECALL_FLOOR, b_recall
    assert s_recall > SCANN_RECALL_FLOOR, s_recall
    return {"shards": n_shards, "bucketed_recall": b_recall,
            "scann_recall": s_recall}


def main(num_rows: int = 40_000, dim: int = 128, batch: int = 4_096,
         device="cuda", ranks=None):
    from recommenders_tpu_torch.examples import sharded_ann_serving

    return launch(sharded_ann_serving.run, device, ranks, num_rows, dim,
                  batch)


if __name__ == "__main__":
    args = parse_args(ranks=True)
    main(device=args.device, ranks=args.ranks)
