"""The explicit id exchange (`parallel.embedding_lookup`) and a
row-sharded `TpuEmbedding` on a (2, 2) gloo mesh, against dense oracles
and the JAX package's `shard_map` functions on a 2 × 4 mesh (mirrors
`tests/test_embedding_lookup.py`).

A lookup copies rows and sums them with zeros: equal. The scatter-add
and the sharded table's gradient sum duplicate ids in batch order, as
the dense oracle does: equal to the port's one-device sums, and to JAX's
within rtol 1e-6 (XLA's scatter may add in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from recommenders_tpu.parallel import embedding_lookup as jax_exchange
from recommenders_tpu.parallel import mesh as jax_mesh

import torch_rank_workers as workers

ROWS, DIM, BATCH = 256, 16, 32


def _setup(seed):
    rng = np.random.RandomState(seed)
    table = rng.normal(size=(ROWS, DIM)).astype(np.float32)
    ids = rng.randint(0, ROWS, BATCH).astype(np.int64)
    ids[:3] = -1  # Padding entries.
    ids[5:9] = ids[10]  # Duplicates.
    grads = rng.normal(size=(BATCH, DIM)).astype(np.float32)
    return table, ids, grads


FCS = (("user", "u", 300, 8, "sum", 0), ("hist", "i", 500, 8, "mean", 0),
       ("seq", "i", 500, 8, "mean", 3))


def _features():
    rng = np.random.RandomState(5)
    hist = rng.randint(0, 500, (8, 4))
    hist[rng.rand(8, 4) < 0.3] = -1
    seq = rng.randint(0, 40, (8, 3))
    seq[0, 0] = -1
    return {"user": rng.randint(0, 300, 8), "hist": hist, "seq": seq}


@pytest.fixture(scope="module")
def ranks():
    out = workers.cases((4, [
        ("exchange_ops", (*_setup(0), -0.1)),
        ("sharded_tpu_embedding", (FCS, _features(), 3)),
    ]))
    return [r[0] for r in out], [r[1] for r in out]


def _jax(table, ids, grads):
    mesh = jax_mesh.create_mesh(shape=(2, 4))
    t = jax.device_put(jnp.asarray(table),
                       NamedSharding(mesh, P("model", None)))
    i = jax.device_put(jnp.asarray(ids, jnp.int32),
                       NamedSharding(mesh, P("data")))
    g = jax.device_put(jnp.asarray(grads),
                       NamedSharding(mesh, P("data", None)))
    return mesh, t, i, g


def _slice(rank):
    d = rank // 2
    return slice(d * BATCH // 2, (d + 1) * BATCH // 2)


def test_sharded_lookup_matches_dense_gather_and_jax(ranks):
    table, ids, grads = _setup(0)
    dense = table[np.maximum(ids, 0)]
    dense[ids < 0] = 0.0
    mesh, t, i, _ = _jax(table, ids, grads)
    want = np.asarray(jax_exchange.sharded_lookup(t, i, mesh))
    for rank, r in enumerate(ranks[0]):
        np.testing.assert_array_equal(r["lookup"], dense[_slice(rank)])
        np.testing.assert_array_equal(r["lookup"], want[_slice(rank)])


def test_sharded_lookup_matches_gspmd(ranks):
    table, ids, grads = _setup(0)
    mesh, t, i, _ = _jax(table, ids, grads)
    want = np.asarray(jax_exchange.gspmd_lookup(t, i, mesh))
    for rank, r in enumerate(ranks[0]):
        np.testing.assert_array_equal(r["gspmd"], r["lookup"])
        np.testing.assert_array_equal(r["gspmd"], want[_slice(rank)])


def test_sharded_scatter_add_matches_dense_and_jax(ranks):
    table, ids, grads = _setup(0)
    dense = table.copy()
    for n, row in enumerate(ids):
        if row >= 0:
            dense[row] += np.float32(-0.1) * grads[n]
    mesh, t, i, g = _jax(table, ids, grads)
    out = jax_exchange.sharded_scatter_add(t, i, g, mesh, scale=-0.1)
    assert out.sharding.spec == P("model", None)
    want = np.asarray(out)
    for rank, r in enumerate(ranks[0]):
        shard = slice((rank % 2) * ROWS // 2, (rank % 2 + 1) * ROWS // 2)
        np.testing.assert_array_equal(r["scatter"], dense[shard])
        np.testing.assert_allclose(r["scatter"], want[shard], rtol=1e-6,
                                   atol=1e-7)


def test_sharded_gather_backward_adds_the_owned_rows(ranks):
    table, ids, grads = _setup(0)
    for rank, r in enumerate(ranks[0]):
        m = rank % 2
        want = np.zeros((ROWS // 2, DIM), np.float32)
        for n in range(*_slice(rank).indices(BATCH)):
            row = max(ids[n], 0) - m * ROWS // 2
            if 0 <= row < ROWS // 2:
                want[row] += grads[n]
        np.testing.assert_array_equal(r["grad"], want)


def test_row_sharded_tpu_embedding_equals_the_whole_tables(ranks):
    """Activations of each data slice and the tables' gradients summed
    over the data axis equal the unsharded layer's on the global batch
    (each rank holds its model shard's rows)."""
    for rank, r in enumerate(ranks[1]):
        m = rank % 2
        for name, acts in r["sharded"]["acts"].items():
            d = rank // 2
            np.testing.assert_array_equal(
                acts, r["whole"]["acts"][name][4 * d:4 * d + 4])
        for name, grad in r["sharded"]["grads"].items():
            whole = r["whole"]["grads"][name]
            per = whole.shape[0] // 2
            np.testing.assert_allclose(grad, whole[m * per:(m + 1) * per],
                                       rtol=1e-6, atol=1e-7)
