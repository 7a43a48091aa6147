"""`parallel.ShardedBruteForce` on four gloo ranks, against the port's
`BruteForce` and the JAX package's `ShardedBruteForce` (mirrors
`tests/test_sharded_corpus.py`).

Ids must be equal (the data has no ties); scores to rtol 1e-5, since
each rank's matmul covers other columns than the one-device matmul. The
ranks run every case in one spawn (`torch_rank_workers.run_cases`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu import metrics as jax_metrics
from recommenders_tpu.layers import factorized_top_k as jax_ftk
from recommenders_tpu.parallel import corpus as jax_corpus
from recommenders_tpu.parallel import mesh as jax_mesh
from recommenders_tpu_torch.layers import factorized_top_k

import torch_rank_workers as workers
from torch_threads import torch_threads  # noqa: F401 (autouse)


def _data(n, d, q, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(q, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


IDENTIFIERS = np.arange(2048, dtype=np.int64) * 3 + 1
TRUE_ROWS = np.random.RandomState(4).randint(0, 4096, 64)
CASES = {
    "n4096": ("sharded_brute_force",
              (*_data(4096, 64, 32), 50, None, 0, (4,))),
    "n3000": ("sharded_brute_force",
              (*_data(3000, 64, 32), 50, None, 0, (4,))),
    "ids": ("sharded_brute_force",
            (*_data(2048, 32, 16, seed=1), 10, IDENTIFIERS, 3, (4,))),
    "mesh": ("sharded_brute_force",
             (*_data(1024, 32, 8, seed=2), 10, None, 0, (2, 2))),
    "metric": ("sharded_metric",
               (*_data(4096, 32, 64, seed=3), TRUE_ROWS, (1, 10, 100))),
}


@pytest.fixture(scope="module")
def ranks():
    names = list(CASES)
    out = workers.cases((4, [CASES[n] for n in names]))
    return {n: [rank[i] for rank in out] for i, n in enumerate(names)}


@pytest.mark.parametrize("n", [4096, 3000])  # Power-of-two and ragged.
def test_sharded_matches_single_device_brute_force(ranks, n):
    queries, corpus = _data(n, 64, 32)
    local = factorized_top_k.BruteForce(k=50, device="cpu").index(
        torch.as_tensor(corpus))
    want_s, want_i = (x.numpy() for x in local(torch.as_tensor(queries)))
    jax_s, jax_i = jax_corpus.ShardedBruteForce(k=50).index(
        jnp.asarray(corpus))(jnp.asarray(queries))
    for r in ranks[f"n{n}"]:
        assert r["shard_rows"] == -(-n // 512) * 128
        np.testing.assert_array_equal(r["ids"], want_i)
        np.testing.assert_array_equal(r["ids"], np.asarray(jax_i))
        np.testing.assert_allclose(r["scores"], want_s, rtol=1e-5)
        np.testing.assert_allclose(r["scores"], np.asarray(jax_s), rtol=1e-5)


def test_sharded_with_identifiers_and_exclusions(ranks):
    queries, corpus = _data(2048, 32, 16, seed=1)
    got = ranks["ids"][0]
    ids = got["ids"]
    assert set(ids.ravel()) <= set(IDENTIFIERS)
    ex_scores, ex_ids = got["excluded"]
    for i in range(16):
        assert not set(ex_ids[i]) & set(ids[i, :3])
    # Remaining results equal positions 3.. of the unexcluded query.
    np.testing.assert_array_equal(ex_ids[:, :7], ids[:, 3:10])
    jax_index = jax_corpus.ShardedBruteForce(k=10).index(
        jnp.asarray(corpus), jnp.asarray(IDENTIFIERS))
    np.testing.assert_array_equal(
        ids, np.asarray(jax_index(jnp.asarray(queries))[1]))


def test_explicit_mesh_axis(ranks):
    """The corpus shards over `model` of a (2, 2) mesh; the data axis
    replicates it."""
    queries, corpus = _data(1024, 32, 8, seed=2)
    ref = factorized_top_k.BruteForce(k=10, device="cpu").index(
        torch.as_tensor(corpus))
    want = ref(torch.as_tensor(queries))[1].numpy()
    jax_index = jax_corpus.ShardedBruteForce(
        k=10, mesh=jax_mesh.create_mesh(shape=(2, 4)),
        axis=jax_mesh.MODEL_AXIS).index(jnp.asarray(corpus))
    for r in ranks["mesh"]:
        assert r["shard_rows"] == 512
        np.testing.assert_array_equal(r["ids"], want)
        np.testing.assert_array_equal(
            r["ids"], np.asarray(jax_index(jnp.asarray(queries))[1]))


def test_factorized_topk_metric_over_sharded_corpus(ranks):
    """Corpus-level eval runs through the sharded index unchanged."""
    queries, corpus = _data(4096, 32, 64, seed=3)
    metric = jax_metrics.FactorizedTopK(
        candidates=jax_ftk.BruteForce(k=100).index(jnp.asarray(corpus)),
        ks=(1, 10, 100))
    state = metric.update(metric.init(), jnp.asarray(queries),
                          jnp.asarray(corpus)[TRUE_ROWS])
    want = {k: float(v) for k, v in metric.result(state).items()}
    for r in ranks["metric"]:
        assert r == want
