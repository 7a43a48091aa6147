"""The port's distributed examples end to end on two gloo ranks on the
CPU, at a tiny size: each example's per-rank body (`run`) in one spawn
of two ranks (`tests/torch_rank_workers.example_runs`), every rank
returning the same finite numbers; and one example through its `main`,
which starts its own ranks (`examples.launch`).
"""

import math

import pytest

import torch_rank_workers
from recommenders_tpu_torch.examples import sharded_ann_serving
from recommenders_tpu_torch.parallel import launch
from torch_threads import torch_threads  # noqa: F401 (autouse)

RUNS = [
    ("tpu_embedding", {"steps": 3}),
    ("distributed_retrieval", {"epochs": 1}),
    ("sharded_ann_serving", {"num_rows": 4_096}),
]


@pytest.fixture(scope="module")
def ranks():
    return launch.run_ranks(torch_rank_workers.example_runs, 2, "gloo",
                            "cpu", RUNS, threads=1)


def test_tpu_embedding(ranks):
    got = [r[0] for r in ranks]
    assert got[0] == got[1]
    assert got[0]["engine_steps"] == 3 and got[0]["tables"] == 2
    assert all(math.isfinite(x) for x in got[0]["losses"])
    assert all("over model (2)" in v for v in got[0]["shardings"].values())


def test_distributed_retrieval(ranks):
    got = [r[1] for r in ranks]
    assert got[0] == got[1]
    assert got[0]["ranks"] == 2 and math.isfinite(got[0]["loss"])
    top10 = got[0]["factorized_top_k/top_10_categorical_accuracy"]
    top100 = got[0]["factorized_top_k/top_100_categorical_accuracy"]
    assert 0 < top10 <= top100 <= 1


def test_sharded_ann_serving(ranks):
    got = [r[2] for r in ranks]
    assert got[0] == got[1]
    assert got[0]["shards"] == 2
    assert got[0]["bucketed_recall"] > sharded_ann_serving.BUCKETED_RECALL_FLOOR
    assert got[0]["scann_recall"] > sharded_ann_serving.SCANN_RECALL_FLOOR


def test_main_starts_its_own_ranks():
    got = sharded_ann_serving.main(num_rows=2_048, device="cpu", ranks=2)
    assert got["shards"] == 2
    assert got["bucketed_recall"] > sharded_ann_serving.BUCKETED_RECALL_FLOOR
