"""`parallel.ShardedBucketed` and `parallel.ShardedScaNN` on four gloo
ranks, against the port's one-device indexes and the JAX package's
sharded ones on a 4-device CPU mesh (mirrors `tests/test_sharded_ann.py`).

Equality discipline (the JAX test's `_assert_topk_equal`): ids equal
except inside score ties; scores equal between the port's sharded and
one-device paths where the shapes match (the reorder), rtol 1e-5
against JAX (the twins sum a dot in another order than XLA) and where
two f32 matmuls of other shapes meet. Every case runs in one spawn of
the ranks (`torch_rank_workers.run_cases`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.layers import approximate as jax_approximate
from recommenders_tpu.parallel import ann as jax_ann
from recommenders_tpu.parallel import mesh as jax_mesh
from recommenders_tpu_torch.layers import approximate
from recommenders_tpu_torch.layers import factorized_top_k
from recommenders_tpu_torch.parallel import ann
from recommenders_tpu_torch.utils import convert

from test_sharded_ann import _assert_topk_equal
import torch_rank_workers as workers


def _clustered(n, d, q, seed=0, clusters=32, noise=0.3):
    rng = np.random.RandomState(seed)
    centers = rng.normal(size=(clusters, d)).astype(np.float32)
    corpus = centers[rng.randint(0, clusters, n)] + noise * rng.normal(
        size=(n, d)).astype(np.float32)
    queries = centers[rng.randint(0, clusters, q)] + noise * rng.normal(
        size=(q, d)).astype(np.float32)
    return queries, corpus


def _jax_mesh():
    return jax_mesh.create_mesh(shape=(4,), axis_names=("model",),
                                devices=jax.devices()[:4])


def _bucketed_params(quantize):
    return dict(buckets=512, chunk=1024 if quantize == "int4" else 512,
                quantize=quantize)


def _scann_params(**kw):
    base = dict(k=20, num_leaves=64, num_leaves_to_search=16,
                training_iterations=4, seed=0, query_batch=64)
    base.update(kw)
    return base


def _jax_scann_arrays(corpus, params):
    index = jax_approximate.ScaNN(**params).index(jnp.asarray(corpus))
    arrays = {n: (None if getattr(index, n) is None
                  else np.asarray(getattr(index, n)))
              for n in convert.SCANN_ARRAYS}
    arrays["_num_candidates"] = index._num_candidates
    return arrays


IDS = np.arange(1536, dtype=np.int64) * 7 + 3
SCANN_CASES = {
    "f32": _scann_params(),
    "int8": _scann_params(quantize="int8"),
    "int4": _scann_params(quantize="int4"),
    "soar": _scann_params(quantize="int8", soar_lambda=1.2),
    "reorder": _scann_params(quantize="int8", num_reordering_candidates=40),
    "bucketed": _scann_params(quantize="int8", scoring_buckets=128,
                              probe_tile=4),
}


def _cases():
    cases = {}
    for quantize in (False, "int8", "int4"):
        for n in (4096, 3000):
            q, c = _clustered(n, 128, 16, seed=0)
            for streamed in (False, True):
                cases[f"bucketed-{quantize}-{n}-{streamed}"] = (
                    "sharded_bucketed",
                    (q, c, 20, _bucketed_params(quantize), (4,), streamed))
    q, c = _clustered(1536, 128, 8, seed=3)
    cases["bucketed-ids"] = ("sharded_bucketed", (
        q, c, 10, _bucketed_params(False), (2, 2), False, IDS, None, 3))
    q, c = _clustered(4096, 128, 16, seed=4)
    for name, params in SCANN_CASES.items():
        cases[f"scann-{name}"] = ("sharded_scann", (q, c, params, (4,)))
        cases[f"scann-{name}-1"] = ("sharded_scann", (q, c, params, None))
    for name in ("int8", "bucketed"):
        arrays = _jax_scann_arrays(c, SCANN_CASES[name])
        cases[f"scann-{name}-jax"] = ("sharded_scann", (
            q, c, SCANN_CASES[name], (4,), False, None, arrays))
    cases["scann-streamed"] = ("sharded_scann", (
        q, c, _scann_params(quantize="int8", kmeans_sample_size=4096),
        (4,), True))
    cases["scann-eager"] = ("sharded_scann", (
        q, c, _scann_params(quantize="int8", kmeans_sample_size=4096),
        (4,), False))
    cases["scann-delegated"] = ("sharded_scann", (
        q, c, _scann_params(quantize="int8", kmeans_sample_size=4096),
        (4,), False, None, None, None, 1 << 20))
    q, c = _clustered(3000, 128, 16, seed=0)
    jax_index = jax_ann.ShardedBucketed(
        k=20, mesh=_jax_mesh(), **_bucketed_params("int4")).index(
            jnp.asarray(c))
    arrays = {"_candidates": np.asarray(jax_index._candidates),
              "_scales": np.asarray(jax_index._scales),
              "_valid": np.asarray(jax_index._valid),
              "_identifiers": None,
              "_num_candidates": jax_index._num_candidates,
              "_rows_per_shard": jax_index._rows_per_shard}
    cases["bucketed-from-jax"] = ("sharded_bucketed_from_jax", (
        q, 20, _bucketed_params("int4"), arrays))
    # Empty slots: one probe of 16-row leaves cannot fill k = 40.
    q, c = _clustered(1024, 128, 8, seed=5)
    empty = _scann_params(num_leaves_to_search=1, leaf_capacity=128)
    cases["scann-empty"] = ("sharded_scann", (
        q, c, empty, (4,), False, np.arange(1024) * 10 + 7, None, 40))
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def ranks():
    names = list(CASES)
    out = workers.cases((4, [CASES[n] for n in names]))
    return {n: [r[i] for r in out] for i, n in enumerate(names)}


def _same_on_every_rank(results):
    for r in results[1:]:
        np.testing.assert_array_equal(r["ids"], results[0]["ids"])
        np.testing.assert_array_equal(r["scores"], results[0]["scores"])
    return results[0]["scores"], results[0]["ids"]


@pytest.mark.parametrize("quantize", [False, "int8", "int4"])
@pytest.mark.parametrize("n", [4096, 3000])  # aligned and ragged
def test_sharded_bucketed_matches_jax_sharded_bucketed(ranks, quantize, n):
    queries, corpus = _clustered(n, 128, 16, seed=0)
    got = _same_on_every_rank(ranks[f"bucketed-{quantize}-{n}-False"])
    assert int(got[1].max()) < n  # no padding rows leak
    index = jax_ann.ShardedBucketed(
        k=20, mesh=_jax_mesh(), **_bucketed_params(quantize)).index(
            jnp.asarray(corpus))
    want = index(jnp.asarray(queries))
    # The twins sum a quantized row's dot in another order than XLA
    # (~4e-7 relative), so every format compares to rtol 1e-5.
    _assert_topk_equal(got, want, f"quantize={quantize} n={n}", rtol=1e-5)


@pytest.mark.parametrize("quantize", [False, "int8", "int4"])
@pytest.mark.parametrize("n", [4096, 3000])
def test_sharded_bucketed_streamed_matches_eager(ranks, quantize, n):
    for eager, streamed in zip(ranks[f"bucketed-{quantize}-{n}-False"],
                               ranks[f"bucketed-{quantize}-{n}-True"]):
        for key in ("candidates", "ids", "scores"):
            np.testing.assert_array_equal(streamed[key], eager[key])
        assert streamed["valid"] == eager["valid"]
        if quantize:
            # Padding rows' scales differ (never read: valid_rows masks
            # them); the valid rows' are equal.
            v = eager["valid"]
            np.testing.assert_array_equal(streamed["scales"][:v],
                                          eager["scales"][:v])
    # Per-rank valid rows: rank i holds [i·rps, (i+1)·rps) of the corpus.
    rps = ranks[f"bucketed-{quantize}-{n}-False"][0]["rps"]
    assert [r["valid"] for r in ranks[f"bucketed-{quantize}-{n}-False"]] == [
        int(np.clip(n - i * rps, 0, rps)) for i in range(4)]


def test_sharded_bucketed_scores_are_exact_dots_and_recall(ranks):
    queries, corpus = _clustered(4096, 128, 16, seed=0)
    scores, rows = _same_on_every_rank(ranks["bucketed-False-4096-False"])
    exact = queries @ corpus.T
    np.testing.assert_allclose(
        scores, np.take_along_axis(exact, rows, axis=1), rtol=1e-5)
    want = factorized_top_k.BruteForce(k=20, device="cpu").index(
        torch.as_tensor(corpus))(torch.as_tensor(queries))[1].numpy()
    single = factorized_top_k.Bucketed(
        k=20, device="cpu", **_bucketed_params(False)).index(
            torch.as_tensor(corpus))(torch.as_tensor(queries))[1].numpy()

    def recall(got):
        return np.mean([len(set(got[r]) & set(want[r])) / 20
                        for r in range(16)])

    # Each rank folds into its own buckets: 4 × the one-device width.
    assert recall(rows) >= recall(single)
    assert recall(rows) > 0.95


def test_sharded_bucketed_identifiers_exclusions_and_mesh(ranks):
    for r in ranks["bucketed-ids"]:
        assert set(r["ids"].ravel()) <= set(IDS)
        _, ex_ids = r["excluded"]
        for i in range(8):
            assert not set(ex_ids[i]) & set(r["ids"][i, :3])
        np.testing.assert_array_equal(ex_ids[:, :7], r["ids"][:, 3:10])


def test_empty_slots_never_decode_to_a_real_identifier():
    ids = torch.tensor([11, 22, 33])
    rows = torch.tensor([[2, -1, 0]])
    scores = torch.tensor([[1.0, 0.5, ann.MIN_FLOAT]])
    np.testing.assert_array_equal(ann._decode_rows(ids, rows, scores),
                                  [[33, -1, -1]])
    np.testing.assert_array_equal(ann._decode_rows(None, rows, scores),
                                  [[2, -1, -1]])
    # JAX's `jnp.take(identifiers, rows)` (`parallel/ann.py:533`) maps
    # row -1 to the last identifier.
    assert int(jnp.take(jnp.asarray([11, 22, 33]), -1)) == 33


def test_sharded_scann_empty_slots_carry_minus_one(ranks):
    single = ranks["scann-empty"]
    scores, got = _same_on_every_rank(single)
    empty = scores <= ann.MIN_FLOAT / 2
    assert empty.any() and (got[empty] == -1).all()
    assert (got[~empty] >= 7).all() and ((got[~empty] - 7) % 10 == 0).all()


@pytest.mark.parametrize("name", ["f32", "int8", "int4", "soar"])
def test_sharded_scann_matches_single_device(ranks, name):
    got = _same_on_every_rank(ranks[f"scann-{name}"])
    want = _same_on_every_rank(ranks[f"scann-{name}-1"])
    _assert_topk_equal(got, want, name)


def test_sharded_scann_ranks_hold_one_partition(ranks):
    for name in SCANN_CASES:
        results = ranks[f"scann-{name}"]
        for r in results[1:]:
            assert r["centroids"].tobytes() == results[0][
                "centroids"].tobytes()
        # Each rank holds its 16 leaves plus the sentinel, whose rows
        # are all -1.
        for r in results:
            assert r["leaf_rows"].shape[0] == 17
            assert (r["leaf_rows"][-1] == -1).all()


def test_sharded_scann_reorder_is_bit_equal_to_single_device(ranks):
    got = _same_on_every_rank(ranks["scann-reorder"])
    want = _same_on_every_rank(ranks["scann-reorder-1"])
    np.testing.assert_array_equal(got[0], want[0])
    _assert_topk_equal(got, want, "reorder")


def test_sharded_scann_bucketed_recall_at_least_single_device(ranks):
    _, corpus = _clustered(4096, 128, 16, seed=4)
    queries, _ = _clustered(4096, 128, 16, seed=4)
    exact = queries @ corpus.T
    want = np.argsort(-exact, axis=1)[:, :20]

    def recall(ids):
        return np.mean([len(set(ids[r]) & set(want[r])) / 20
                        for r in range(16)])

    got = _same_on_every_rank(ranks["scann-bucketed"])[1]
    single = _same_on_every_rank(ranks["scann-bucketed-1"])[1]
    assert recall(got) >= recall(single) - 1e-9


@pytest.mark.parametrize("name", ["int8", "bucketed"])
def test_sharded_scann_matches_jax_on_the_same_leaves(ranks, name):
    queries, corpus = _clustered(4096, 128, 16, seed=4)
    got = _same_on_every_rank(ranks[f"scann-{name}-jax"])
    index = jax_ann.ShardedScaNN(
        jax_approximate.ScaNN(**SCANN_CASES[name]), mesh=_jax_mesh()).index(
            jnp.asarray(corpus))
    want = index(jnp.asarray(queries))
    _assert_topk_equal(got, want, name, rtol=1e-5)


def test_sharded_scann_streamed_matches_eager(ranks):
    got = _same_on_every_rank(ranks["scann-streamed"])
    want = _same_on_every_rank(ranks["scann-eager"])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_oversized_host_corpus_takes_the_streamed_build(ranks):
    """A NumPy corpus past the build budget goes to `index_streamed`
    (the same leaves as the streamed build; `parallel/ann.py:629-648`)."""
    got = _same_on_every_rank(ranks["scann-delegated"])
    want = _same_on_every_rank(ranks["scann-streamed"])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_jax_sharded_bucketed_state_loads_per_rank(ranks):
    """`convert.sharded_bucketed_from_numpy`: each rank keeps its row of
    the JAX index's stacked int4 codes, scales and valid counts, and
    serves the JAX index's results."""
    queries, corpus = _clustered(3000, 128, 16, seed=0)
    index = jax_ann.ShardedBucketed(
        k=20, mesh=_jax_mesh(), **_bucketed_params("int4")).index(
            jnp.asarray(corpus))
    want = index(jnp.asarray(queries))
    got = _same_on_every_rank(ranks["bucketed-from-jax"])
    _assert_topk_equal(got, want, "int4 from JAX", rtol=1e-5)
    # The same storage as the port's own build of that corpus.
    for own, loaded in zip(ranks["bucketed-int4-3000-False"],
                           ranks["bucketed-from-jax"]):
        np.testing.assert_array_equal(own["ids"], loaded["ids"])


def test_sharded_scann_rejects_unsupported_configs():
    with pytest.raises(ValueError, match="ScaNN"):
        ann.ShardedScaNN(factorized_top_k.BruteForce(device="cpu"))
    with pytest.raises(ValueError, match="quantize"):
        ann.ShardedBucketed(quantize="int2", device="cpu")
