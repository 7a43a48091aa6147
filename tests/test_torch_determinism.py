"""Fixed-order sums: `gather_rows`' backward and the device k-means'
cluster sums (`ops.sparse_apply.fixed_order_index_add_`).

On the CPU, against the JAX functions they port: the gradient of a
gather with duplicate ids (JAX's `take` transposes to a scatter-add)
and one Lloyd step (`segment_sum`), equal where the sums are exact and
to rtol 1e-6 otherwise. On the card (marked `cuda`, skipped without
one, `tests/test_torch_cuda_determinism.py`): two backward passes with
many duplicates are bit-equal, and equal to the CPU's sequential sums;
two k-means runs are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.layers import approximate as jax_approximate
from recommenders_tpu_torch.embedding import embedding
from recommenders_tpu_torch.layers import approximate
from recommenders_tpu_torch.ops import sparse_apply
from torch_threads import torch_threads  # noqa: F401 (autouse)


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


def test_gather_grad_matches_jax():
    table, ids, cot = _gather_problem()

    def loss(t):
        rows = jnp.take(t, jnp.maximum(jnp.asarray(ids), 0), axis=0)
        rows = jnp.where((jnp.asarray(ids) == -1)[:, None], 0.0, rows)
        return jnp.sum(rows * cot)

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    got = _port_grad(table, ids, cot).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_fixed_order_add_is_the_sequential_sum_on_the_cpu():
    _, ids, cot = _gather_problem(1)
    rows = torch.as_tensor(np.maximum(ids, 0))
    got = sparse_apply.fixed_order_index_add_(
        torch.zeros(64, 16), rows, torch.as_tensor(cot))
    want = torch.zeros(64, 16)
    for i in range(len(ids)):
        want[rows[i]] += torch.as_tensor(cot[i])
    assert torch.equal(got, want)


def test_kmeans_step_matches_jax_segment_sum():
    rng = np.random.RandomState(2)
    corpus = rng.normal(size=(3000, 8)).astype(np.float32)
    centroids = corpus[rng.choice(3000, 16, replace=False)]
    reseed = corpus[rng.randint(0, 3000, 16)]
    got = approximate._kmeans_step_device(
        torch.as_tensor(corpus), torch.as_tensor(centroids),
        torch.as_tensor(reseed), 16, chunk=1024).numpy()
    want = np.asarray(jax_approximate._kmeans_step_device(
        jnp.asarray(corpus), jnp.asarray(centroids), jnp.asarray(reseed),
        16, chunk=1024))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
