"""Shared pieces of the benchmark's own tests (run them with
`python -m pytest portbench/tests -q`; the repo's tier-1 run does not
collect them)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Sizes at which a whole run holds on the CPU: the cells' files as they
# are, but for the catalog's rows and the index's depth, with buckets
# enough for k = 100 that recall reads as it does at the cells' size.
TINY = {
    "scann": {
        "config": {"catalog": {"rows": 20000, "batch": 5000, "centers": 16},
                   "settings": {"num_leaves": 16, "num_leaves_to_search": 8,
                                "leaf_capacity": 2048,
                                "scoring_buckets": 2048, "probe_tile": 32,
                                "kmeans_sample_size": 4096,
                                "training_iterations": 4}},
        "traffic": {"pool_requests": 4, "warmup_requests": 1,
                    "trace_seconds": 0.3},
        "check": {"requests": 2, "code_rows": 4096}},
    "bucketed": {
        "config": {"catalog": {"rows": 20000, "batch": 5000, "centers": 16},
                   "settings": {"buckets": 4096, "chunk": 4096,
                                "query_tile": 32}},
        "traffic": {"pool_requests": 4, "warmup_requests": 1,
                    "trace_seconds": 0.3},
        "check": {"requests": 2, "code_rows": 4096}},
}


def tiny(cell: str) -> dict:
    return TINY["scann" if cell.startswith("scann") else "bucketed"]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
