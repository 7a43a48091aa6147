"""Fixed-order sums on the card (marked `cuda`; each test skips without
one; no JAX needed): `gather_rows`' backward with many duplicate ids is
bit-equal run to run and equal to the CPU's sequential sums, and two
device k-means builds from one seed are bit-equal.

    python -m pytest tests/test_torch_cuda_determinism.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from recommenders_tpu_torch.embedding import embedding
from recommenders_tpu_torch.tools import determinism
from torch_threads import torch_threads  # noqa: F401 (autouse)

pytestmark = pytest.mark.cuda


def _gather_problem(seed=0, rows=64, dim=16, n=4096):
    rng = np.random.RandomState(seed)
    table = rng.normal(size=(rows, dim)).astype(np.float32)
    # Skewed ids: a few rows take most of the batch.
    ids = np.minimum(rng.zipf(1.3, n) - 1, rows - 1).astype(np.int64)
    ids[:5] = -1   # PAD_ID rows read zeros and get no gradient.
    cot = rng.normal(size=(n, dim)).astype(np.float32)
    return table, ids, cot


def _port_grad(table, ids, cot, device="cpu"):
    t = torch.tensor(table, device=device, requires_grad=True)
    out = embedding.gather_rows(t, torch.as_tensor(ids, device=device))
    torch.sum(out * torch.as_tensor(cot, device=device)).backward()
    return t.grad


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def test_gather_grad_is_bit_equal_run_to_run_on_the_card(cuda):
    table, ids, cot = _gather_problem(3, rows=1024, dim=64, n=1 << 17)
    first = _port_grad(table, ids, cot, cuda)
    second = _port_grad(table, ids, cot, cuda)
    assert torch.equal(first, second)
    assert torch.equal(first.cpu(), _port_grad(table, ids, cot))


def test_kmeans_build_is_bit_equal_run_to_run_on_the_card(cuda):
    runs = determinism.twice(
        lambda: determinism.scann_partition(cuda, 0, 100_000))
    assert runs["bit_equal"], runs
