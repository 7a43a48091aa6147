"""Port parity for the ScaNN index (`layers/approximate.py`).

Mirrors tests/test_approximate.py and tests/test_scann_streamed.py at
their sizes, on the port with `device="cpu"` (where the leaf-scoring
wrappers run their plain twins). Where the two packages must agree
exactly — the integer packing logic for the same choices, the NumPy draws
— the JAX package runs beside the port on the same NumPy inputs.

Tolerances: scores that are exact dot products, to rtol=atol=1e-4 (f32
sums in another order at D ≤ 128); one Lloyd step's centroids to 1e-5
(per-cluster sums of up to 3000 rows in another order); recall-type
checks use the JAX tests' own limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.layers import approximate as jax_approx
from recommenders_tpu_torch.layers import approximate
from recommenders_tpu_torch.layers import factorized_top_k
from torch_threads import torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def _data(n, d, q, seed=0):
    rng = np.random.RandomState(seed)
    return (
        rng.normal(size=(q, d)).astype(np.float32),
        rng.normal(size=(n, d)).astype(np.float32),
    )


def _clustered(n, q, d=32, num_centers=64, seed=0, scale=4.0):
    rng = np.random.RandomState(seed)
    centers = rng.normal(scale=scale, size=(num_centers, d)).astype(
        np.float32)
    corpus = (centers[rng.randint(0, num_centers, n)]
              + rng.normal(size=(n, d)).astype(np.float32))
    queries = (centers[rng.randint(0, num_centers, q)]
               + rng.normal(size=(q, d)).astype(np.float32))
    return queries, corpus


def _scann(**kw):
    return approximate.ScaNN(device=CPU, **kw)


def _t(x):
    return torch.from_numpy(np.array(x))


def _exact_ids(queries, corpus, k):
    return np.argsort(-(queries @ corpus.T), axis=1, kind="stable")[:, :k]


def _recall(ids, exact_ids):
    ids = np.asarray(ids)
    k = exact_ids.shape[1]
    return np.mean([len(np.intersect1d(exact_ids[i], ids[i])) / k
                    for i in range(exact_ids.shape[0])])


def test_single_leaf_is_exact():
    queries, corpus = _data(500, 32, 16)
    index = _scann(k=10, num_leaves=1, num_leaves_to_search=1)
    scores, ids = index.index(_t(corpus))(_t(queries))
    ref_ids = _exact_ids(queries, corpus, 10)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    full = queries @ corpus.T
    np.testing.assert_allclose(scores.numpy(),
                               np.take_along_axis(full, ref_ids, axis=1),
                               rtol=1e-4, atol=1e-4)


def test_partitioned_recall_beats_probe_fraction():
    queries, corpus = _clustered(4000, 64, num_centers=32)
    index = _scann(k=10, num_leaves=64, num_leaves_to_search=8,
                   training_iterations=5).index(_t(corpus))
    _, ids = index(_t(queries))
    assert _recall(ids, _exact_ids(queries, corpus, 10)) > 0.8


def test_quantized_with_reorder_recovers_exact_scores():
    queries, corpus = _data(2000, 64, 32, seed=1)
    index = _scann(k=10, num_leaves=1, num_leaves_to_search=1,
                   quantize=True, num_reordering_candidates=50)
    scores, ids = index.index(_t(corpus))(_t(queries))
    full = queries @ corpus.T
    np.testing.assert_allclose(
        scores.numpy(), np.take_along_axis(full, ids.numpy(), axis=1),
        rtol=1e-4, atol=1e-4)
    assert np.mean(ids.numpy() == _exact_ids(queries, corpus, 10)) > 0.95


def test_custom_identifiers_and_exclusions():
    queries, corpus = _data(300, 32, 8, seed=3)
    identifiers = np.arange(300, dtype=np.int64) * 7 + 3
    index = _scann(k=5, num_leaves=1, num_leaves_to_search=1)
    index.index(_t(corpus), _t(identifiers))
    _, ids = index(_t(queries))
    assert set(ids.numpy().ravel()) <= set(identifiers)
    exclusions = ids[:, :2]
    _, ex_ids = index.query_with_exclusions(_t(queries), exclusions, k=5)
    for i in range(8):
        assert not set(ex_ids[i].tolist()) & set(exclusions[i].tolist())


def test_index_from_dataset_batches():
    queries, corpus = _data(512, 32, 4, seed=4)
    batches = [(torch.arange(i, i + 128, dtype=torch.int32),
                _t(corpus[i:i + 128])) for i in range(0, 512, 128)]
    index = _scann(k=10, num_leaves=1, num_leaves_to_search=1)
    _, ids = index.index_from_dataset(batches)(_t(queries))
    np.testing.assert_array_equal(ids.numpy(),
                                  _exact_ids(queries, corpus, 10))


def test_is_exact_and_unbuilt_error():
    index = _scann()
    assert not index.is_exact()
    with pytest.raises(ValueError, match="index"):
        index(torch.zeros((2, 8)))


def test_scann_is_reexported_from_factorized_top_k():
    assert factorized_top_k.ScaNN is approximate.ScaNN
    with pytest.raises(AttributeError):
        factorized_top_k.NotAnIndex  # noqa: B018


def test_query_chunking_matches_unchunked():
    queries, corpus = _data(2000, 64, 50, seed=5)
    kwargs = dict(k=10, num_leaves=20, num_leaves_to_search=5, seed=3)
    chunked = _scann(query_batch=16, **kwargs).index(_t(corpus))
    whole = _scann(query_batch=512, **kwargs).index(_t(corpus))
    cs, ci = chunked(_t(queries))
    ws, wi = whole(_t(queries))
    np.testing.assert_array_equal(ci.numpy(), wi.numpy())
    np.testing.assert_allclose(cs.numpy(), ws.numpy(), rtol=1e-5, atol=1e-5)


# --- Packing: integer logic, equal to JAX's for the same choices -------------

def _pack_both(choices, num_leaves, capacity):
    got = approximate._pack_assign_device(_t(choices), num_leaves, capacity)
    want = jax_approx._pack_assign_device(jnp.asarray(choices), num_leaves,
                                          capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return [g.numpy() for g in got]


def test_pack_assign_device_places_all_rows_uniquely():
    rng = np.random.RandomState(7)
    corpus = rng.normal(size=(3000, 16)).astype(np.float32)
    centroids = jax_approx.kmeans(corpus, 24, iterations=4)
    choices = np.asarray(jax_approx._topr_assign_device(
        jnp.asarray(corpus), jnp.asarray(centroids), 8, 1024))
    port_choices = approximate._topr_assign_device(
        _t(corpus), _t(centroids), 8, 1024).numpy()
    assert np.mean(port_choices == choices) > 0.999   # top-8 near-ties
    capacity = approximate._round_up(int(np.ceil(1.3 * 3000 / 24)), 128)
    leaf_of, slot_of, unplaced = _pack_both(choices, 24, capacity)
    assert int(unplaced) == 0
    assert (leaf_of < 24).all() and (slot_of < capacity).all()
    cells = leaf_of.astype(np.int64) * capacity + slot_of
    assert len(np.unique(cells)) == 3000
    assert (leaf_of[:, None] == choices).any(axis=1).all()


def test_pack_assign_device_spills_on_tight_capacity():
    rng = np.random.RandomState(1)
    corpus = np.concatenate([rng.normal(loc=5.0, size=(200, 8)),
                             rng.normal(loc=-5.0, size=(56, 8))]
                            ).astype(np.float32)
    centroids = np.stack([corpus[:200].mean(0), corpus[200:].mean(0)]
                         ).astype(np.float32)
    choices = approximate._topr_assign_device(
        _t(corpus), _t(centroids), 2, 1024).numpy()
    leaf_of, _, unplaced = _pack_both(choices, 2, 128)
    assert int(unplaced) == 0
    assert np.bincount(leaf_of, minlength=2).tolist() == [128, 128]


def test_pack_assign_device_fallback_fills_global_capacity():
    rng = np.random.RandomState(11)
    corpus = rng.normal(loc=3.0, scale=0.1, size=(512, 8)).astype(np.float32)
    centroids = np.concatenate([corpus[:1], rng.normal(size=(7, 8))]
                               ).astype(np.float32)
    choices = approximate._topr_assign_device(
        _t(corpus), _t(centroids), 2, 1024).numpy()
    leaf_of, slot_of, unplaced = _pack_both(choices, 8, 64)
    assert int(unplaced) == 0
    counts = np.bincount(leaf_of, minlength=8)
    assert counts.sum() == 512 and counts.max() <= 64
    assert len(np.unique(leaf_of.astype(np.int64) * 64 + slot_of)) == 512


def test_pack_assign_device_reports_true_shortage():
    _, _, unplaced = _pack_both(np.zeros((100, 1), np.int32), 1, 64)
    assert int(unplaced) == 36


def test_pack_assign_device_random_choices_equal_jax():
    rng = np.random.RandomState(12)
    choices = rng.randint(0, 16, size=(2000, 4)).astype(np.int32)
    choices[:300] = 3                                 # one hot leaf
    _pack_both(choices, 16, 128)


# --- k-means ----------------------------------------------------------------

@pytest.mark.parametrize("balance", [0, 4])
def test_kmeans_step_matches_jax(balance):
    rng = np.random.RandomState(13)
    corpus = rng.normal(size=(3000, 32)).astype(np.float32)
    centroids = corpus[rng.choice(3000, 24, replace=False)]
    centroids[5] = 100.0                              # an empty cluster
    reseed = corpus[rng.randint(0, 3000, 24)]
    got = approximate._kmeans_step_device(_t(corpus), _t(centroids),
                                          _t(reseed), 24, 1024, balance)
    want = np.asarray(jax_approx._kmeans_step_device(
        jnp.asarray(corpus), jnp.asarray(centroids), jnp.asarray(reseed), 24,
        1024, balance=balance))
    np.testing.assert_array_equal(
        approximate._assign_device(_t(corpus), _t(centroids), 1024).numpy(),
        np.asarray(jax_approx._assign_device(
            jnp.asarray(corpus), jnp.asarray(centroids), 1024)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_kmeans_draws_the_same_initial_centroids_as_jax():
    rng = np.random.RandomState(14)
    corpus = rng.normal(size=(2000, 16)).astype(np.float32)
    for sample in (None, 700):
        got = approximate.kmeans_device(_t(corpus), 12, iterations=0,
                                        seed=3, sample=sample)
        want = jax_approx.kmeans_device(jnp.asarray(corpus), 12,
                                        iterations=0, seed=3, sample=sample)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = approximate.kmeans(corpus, 12, iterations=0, seed=3, device=CPU)
    np.testing.assert_array_equal(
        got, jax_approx.kmeans(corpus, 12, iterations=0, seed=3))


def test_device_build_recall_matches_host_build():
    queries, corpus = _clustered(4000, 64, num_centers=32, seed=5)
    exact = _exact_ids(queries, corpus, 10)
    kwargs = dict(k=10, num_leaves=64, num_leaves_to_search=8,
                  training_iterations=5, quantize=True, seed=2)
    host = _scann(**kwargs).index(corpus)
    dev = _scann(**kwargs).index(_t(corpus))
    r_host = _recall(host(_t(queries))[1], exact)
    r_dev = _recall(dev(_t(queries))[1], exact)
    assert r_dev > 0.8, r_dev
    assert abs(r_dev - r_host) < 0.1, (r_host, r_dev)


def test_device_build_with_kmeans_sample():
    queries, corpus = _data(2000, 32, 16, seed=9)
    index = _scann(k=10, num_leaves=16, num_leaves_to_search=16,
                   kmeans_sample_size=500).index(_t(corpus))
    _, ids = index(_t(queries))
    np.testing.assert_array_equal(ids.numpy(),
                                  _exact_ids(queries, corpus, 10))


def test_kmeans_balance_reduces_leaf_skew():
    rng = np.random.RandomState(0)
    centers = rng.normal(size=(16, 64)).astype(np.float32)
    blob = np.where(rng.uniform(size=4096) < 0.8, rng.randint(0, 2, 4096),
                    rng.randint(0, 16, 4096))
    corpus = centers[blob] + 0.2 * rng.normal(size=(4096, 64)).astype(
        np.float32)
    queries = corpus[rng.randint(0, 4096, 32)]

    def build(balance):
        idx = _scann(k=10, num_leaves=32, num_leaves_to_search=12,
                     training_iterations=12, seed=0,
                     kmeans_balance_fraction=balance).index(_t(corpus))
        return idx, idx._leaf_valid.sum(dim=1).numpy()

    _, plain_loads = build(0.0)
    bal, bal_loads = build(0.25)
    assert bal_loads.max() < plain_loads.max()
    assert _recall(bal(_t(queries))[1], _exact_ids(queries, corpus, 10)
                   ) > 0.85


# --- Storage dtypes ----------------------------------------------------------

def test_bf16_leaves_match_f32_recall():
    queries, corpus = _data(2000, 64, 32, seed=13)
    kw = dict(k=10, num_leaves=16, num_leaves_to_search=16,
              training_iterations=3)
    f32 = _scann(**kw).index(_t(corpus))
    bf16 = _scann(leaf_dtype=torch.bfloat16, **kw).index(_t(corpus))
    assert bf16._leaf_embs.dtype == torch.bfloat16
    s32, i32 = f32(_t(queries))
    s16, i16 = bf16(_t(queries))
    assert np.mean(i16.numpy() == i32.numpy()) > 0.95
    np.testing.assert_allclose(s16.numpy(), s32.numpy(), rtol=2e-2,
                               atol=5e-2)


def test_bf16_reorder_matches_f32_ids():
    queries, corpus = _data(3000, 64, 32, seed=14)
    kw = dict(k=10, num_leaves=16, num_leaves_to_search=8, quantize=True,
              num_reordering_candidates=60, training_iterations=3)
    f32 = _scann(**kw).index(_t(corpus))
    bf16 = _scann(reorder_dtype=torch.bfloat16, **kw).index(_t(corpus))
    assert bf16._corpus.dtype == torch.bfloat16
    _, i32 = f32(_t(queries))
    s16, i16 = bf16(_t(queries))
    assert np.mean(i16.numpy() == i32.numpy()) > 0.9
    full = queries @ corpus.T
    np.testing.assert_allclose(
        s16.numpy(), np.take_along_axis(full, i16.numpy(), axis=1),
        rtol=2e-2, atol=8e-2)


def test_host_build_honors_leaf_and_reorder_dtypes():
    queries, corpus = _data(500, 32, 8, seed=15)
    index = _scann(k=5, num_leaves=4, num_leaves_to_search=4,
                   leaf_dtype=torch.bfloat16, reorder_dtype=torch.bfloat16,
                   num_reordering_candidates=20,
                   training_iterations=2).index(corpus)
    assert index._leaf_embs.dtype == torch.bfloat16
    assert index._corpus.dtype == torch.bfloat16
    _, ids = index(_t(queries))
    assert np.mean(ids.numpy() == _exact_ids(queries, corpus, 5)) > 0.9


def test_int4_host_and_device_builds_store_the_same_layout():
    """Both builds pack slot s and slot s + cap/2 of a leaf into one byte:
    every valid slot unpacks to its row's int4 codes."""
    from recommenders_tpu_torch.ops import quantization

    _, corpus = _data(700, 32, 1, seed=16)
    kw = dict(k=5, num_leaves=4, num_leaves_to_search=4, quantize="int4",
              training_iterations=2, anisotropic_quantization_threshold=None)
    _, want = quantization.quantize_rows(corpus, None, bits=4)
    for index in (_scann(**kw).index(corpus), _scann(**kw).index(_t(corpus))):
        assert index._leaf_embs.shape == (4, 128, 32)   # cap 256, packed
        codes = quantization.unpack_nibbles(index._leaf_embs)
        valid = index._leaf_valid
        rows = index._leaf_rows[valid].long().numpy()
        assert sorted(rows.tolist()) == list(range(700))
        assert np.mean(codes[valid].numpy() == want[rows]) > 0.999


def test_dtype_validation():
    with pytest.raises(ValueError, match="leaf_dtype"):
        _scann(leaf_dtype=torch.int8)
    with pytest.raises(ValueError, match="reorder_dtype"):
        _scann(reorder_dtype=torch.float16)
    with pytest.raises(ValueError, match="quantize"):
        _scann(quantize=True, leaf_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="quantize"):
        _scann(quantize="int2")


def test_capacity_grain_and_bounds():
    assert _scann()._capacity(100, 10_000) == 256
    assert _scann(quantize="int4")._capacity(100, 10_000) == 256
    assert _scann(quantize="int4")._capacity(100, 5_000) == 256
    assert _scann(quantize="int8")._capacity(100, 5_000) == 128
    assert _scann(soar_lambda=1.0)._capacity(100, 10_000) == 384
    with pytest.raises(ValueError, match="cannot hold"):
        _scann(leaf_capacity=10)._capacity(4, 100)


# --- SOAR --------------------------------------------------------------------

def test_soar_improves_recall_at_fixed_probes():
    queries, corpus = _clustered(8000, 128)
    exact = _exact_ids(queries, corpus, 10)
    recalls = {}
    for lam in (None, 1.5):
        index = _scann(k=10, num_leaves=64, num_leaves_to_search=2,
                       training_iterations=5, soar_lambda=lam
                       ).index(_t(corpus))
        ids = index(_t(queries))[1].numpy()
        assert all(len(set(r.tolist())) == len(r) for r in ids)
        recalls[lam] = _recall(ids, exact)
    assert recalls[1.5] > recalls[None], recalls


def test_soar_exact_when_all_leaves_probed():
    queries, corpus = _data(1000, 32, 16, seed=17)
    index = _scann(k=10, num_leaves=8, num_leaves_to_search=8,
                   soar_lambda=1.0, training_iterations=3).index(corpus)
    np.testing.assert_array_equal(index(_t(queries))[1].numpy(),
                                  _exact_ids(queries, corpus, 10))


def test_soar_with_quantize_and_reorder():
    queries, corpus = _clustered(4000, 64, seed=3)
    index = _scann(k=10, num_leaves=64, num_leaves_to_search=8,
                   soar_lambda=1.5, quantize=True,
                   num_reordering_candidates=40, training_iterations=5
                   ).index(_t(corpus))
    scores, ids = index(_t(queries))
    ids = ids.numpy()
    assert all(len(set(r.tolist())) == len(r) for r in ids)
    np.testing.assert_allclose(
        scores.numpy(), np.take_along_axis(queries @ corpus.T, ids, axis=1),
        rtol=1e-4, atol=1e-4)


def test_soar_validation():
    with pytest.raises(ValueError, match="soar_lambda"):
        _scann(soar_lambda=-1.0)


# --- The bucketed path (K5) --------------------------------------------------

def test_bucketed_scoring_near_exact_when_all_probed():
    queries, corpus = _data(800, 128, 16, seed=19)
    index = _scann(k=10, num_leaves=4, num_leaves_to_search=4,
                   scoring_buckets=1024, training_iterations=3
                   ).index(_t(corpus))
    scores, ids = index(_t(queries))
    full = queries @ corpus.T
    assert np.mean(ids.numpy() == _exact_ids(queries, corpus, 10)) > 0.9
    np.testing.assert_allclose(
        scores.numpy(), np.take_along_axis(full, ids.numpy(), axis=1),
        rtol=1e-4, atol=1e-4)


def test_probe_tile_recall_close_to_per_query():
    queries, corpus = _clustered(20000, 128, d=128, seed=7)
    exact = _exact_ids(queries, corpus, 10)
    per_query = _scann(k=10, num_leaves=64, num_leaves_to_search=8,
                       scoring_buckets=1024, training_iterations=5
                       ).index(_t(corpus))
    tiled = _scann(k=10, num_leaves=64, num_leaves_to_search=32,
                   scoring_buckets=1024, probe_tile=8, training_iterations=5
                   ).index(_t(corpus))
    r_pq = _recall(per_query(_t(queries))[1], exact)
    r_t = _recall(tiled(_t(queries))[1], exact)
    assert r_t > r_pq - 0.03, (r_pq, r_t)


def test_bucketed_with_soar_and_reorder():
    queries, corpus = _clustered(10000, 64, d=128, seed=9)
    index = _scann(k=10, num_leaves=64, num_leaves_to_search=16,
                   scoring_buckets=1024, probe_tile=8, soar_lambda=1.5,
                   quantize=True, num_reordering_candidates=40,
                   training_iterations=5).index(_t(corpus))
    scores, ids = index(_t(queries))
    ids = ids.numpy()
    assert all(len(set(r.tolist())) == len(r) for r in ids)
    np.testing.assert_allclose(
        scores.numpy(), np.take_along_axis(queries @ corpus.T, ids, axis=1),
        rtol=1e-4, atol=1e-4)


def test_bucketed_odd_query_count_pads():
    queries, corpus = _clustered(6000, 77, d=128, num_centers=16, seed=20)
    index = _scann(k=5, num_leaves=16, num_leaves_to_search=8,
                   scoring_buckets=512, probe_tile=4, training_iterations=4
                   ).index(_t(corpus))
    _, ids = index(_t(queries))
    assert ids.shape == (77, 5)
    assert _recall(ids, _exact_ids(queries, corpus, 5)) > 0.75


def test_tile_probes_match_jax():
    rng = np.random.RandomState(21)
    queries = rng.normal(size=(24, 16)).astype(np.float32)
    cscores = rng.normal(size=(24, 12)).astype(np.float32)
    for probes, tile in ((5, 1), (7, 4), (3, 8), (16, 8)):
        got = approximate._tile_probes(_t(queries), _t(cscores), probes,
                                       tile)
        want = jax_approx._tile_probes(jnp.asarray(queries),
                                       jnp.asarray(cscores), probes, tile)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scoring_buckets_validation():
    with pytest.raises(ValueError, match="scoring_buckets"):
        _scann(scoring_buckets=200)
    with pytest.raises(ValueError, match="probe_tile"):
        _scann(probe_tile=0)
    with pytest.raises(ValueError, match="probe_tile"):
        _scann(probe_tile=8)


# --- Empty result slots (a reference defect the port does not copy) ----------

@pytest.mark.parametrize("settings", [
    dict(), dict(quantize="int8", num_reordering_candidates=300),
    dict(scoring_buckets=128), dict(soar_lambda=1.0),
])
@pytest.mark.parametrize("string_ids", [False, True])
def test_empty_result_slots_carry_no_real_identifier(settings, string_ids):
    """k larger than the probed valid slots: the JAX package returns row
    0's identifier for the empty slots (padding `leaf_ids` are 0, and the
    bucketed path takes `identifiers[max(row, 0)]`); the port returns -1,
    and a string index decodes it to the empty string."""
    _, corpus = _data(300, 16, 1, seed=22)
    ids = np.asarray([f"item{i}" for i in range(300)]) if string_ids else (
        np.arange(300, dtype=np.int64) + 1000)
    index = _scann(k=200, num_leaves=4, num_leaves_to_search=1,
                   training_iterations=2, **settings)
    index.index(_t(corpus), ids if string_ids else _t(ids))
    queries = _t(corpus[:3])
    scores, got = index(queries)
    got = np.asarray(got)
    live = scores.numpy() > approximate.MIN_FLOAT / 2
    assert (~live).any(), "the probe must hold fewer than k valid rows"
    empty = "" if string_ids else approximate.EMPTY_ID
    assert (got[~live] == empty).all()
    for row, mask in zip(got, live):
        assert len(set(row[mask].tolist())) == mask.sum()
        assert set(row[mask].tolist()) <= set(ids.tolist())


# --- The streamed build (mirrors tests/test_scann_streamed.py) ---------------

def _stream_data(n, d, q, seed=0, clusters=16, noise=0.3):
    rng = np.random.RandomState(seed)
    centers = rng.normal(size=(clusters, d)).astype(np.float32)
    corpus = centers[rng.randint(0, clusters, n)] + noise * rng.normal(
        size=(n, d)).astype(np.float32)
    queries = centers[rng.randint(0, clusters, q)] + noise * rng.normal(
        size=(q, d)).astype(np.float32)
    return _t(queries), _t(corpus)


def _params(n, **kw):
    return dict(dict(k=20, num_leaves=32, num_leaves_to_search=8,
                     training_iterations=4, seed=0, query_batch=64,
                     kmeans_sample_size=n), **kw)


def _batches(corpus, batch):
    def factory():
        for i in range(0, corpus.shape[0], batch):
            yield corpus[i:i + batch]

    return factory


@pytest.mark.parametrize("quantize", [False, "int8", "int4"])
def test_streamed_build_matches_one_shot(quantize):
    n = 3000
    queries, corpus = _stream_data(n, 128, 16)
    one_shot = _scann(**_params(n, quantize=quantize)).index(corpus)
    streamed = _scann(**_params(n, quantize=quantize)).index_streamed(
        _batches(corpus, 700), num_rows=n)
    for name in ("_centroids", "_leaf_embs", "_leaf_rows", "_leaf_valid"):
        assert torch.equal(getattr(one_shot, name), getattr(streamed, name))
    if quantize:
        assert torch.equal(one_shot._leaf_scales, streamed._leaf_scales)
    ws, wi = one_shot(queries)
    gs, gi = streamed(queries)
    assert torch.equal(wi, gi) and torch.equal(ws, gs)


def test_streamed_identifiers_and_rows_as_ids():
    n = 2000
    queries, corpus = _stream_data(n, 128, 8, seed=1)
    ids = torch.arange(n, dtype=torch.int32) * 5 + 2
    with_ids = _scann(**_params(n, quantize="int8")).index_streamed(
        _batches(corpus, 512), n, identifiers=ids)
    rows_as_ids = _scann(**_params(n, quantize="int8")).index_streamed(
        _batches(corpus, 512), n)
    assert torch.equal(with_ids(queries)[1], rows_as_ids(queries)[1] * 5 + 2)


def test_streamed_bucketed_scoring_path():
    n = 2000
    queries, corpus = _stream_data(n, 128, 8, seed=2)
    index = _scann(**_params(n, quantize="int8", scoring_buckets=128))
    index.index_streamed(_batches(corpus, 512), n)
    assert index._flat_ids is None
    scores, ids = index(queries, k=10)
    assert scores.shape == (8, 10)
    assert int(ids.max()) < n


def test_streamed_rejects_soar_reorder_and_bad_counts():
    n = 1000
    _, corpus = _stream_data(n, 128, 4, seed=3)
    with pytest.raises(ValueError, match="soar"):
        _scann(**_params(n, soar_lambda=1.0)).index_streamed(
            _batches(corpus, 500), n)
    with pytest.raises(ValueError, match="reorder"):
        _scann(**_params(n, num_reordering_candidates=40)).index_streamed(
            _batches(corpus, 500), n)
    with pytest.raises(ValueError, match="num_rows"):
        _scann(**_params(n)).index_streamed(_batches(corpus, 500), n + 7)


def test_streamed_build_matches_jax_leaves():
    """Same corpus and seed, no Lloyd iteration: the same sampled
    centroids (the NumPy draws of both passes), bit for bit, and the same
    packing but for assignment near-ties."""
    n = 2000
    _, corpus = _stream_data(n, 128, 1, seed=4)
    kw = _params(n, quantize="int8", kmeans_sample_size=700,
                 training_iterations=0)
    port = _scann(**kw).index_streamed(_batches(corpus, 500), n)
    jax_index = jax_approx.ScaNN(**kw).index_streamed(
        [jnp.asarray(corpus[i:i + 500].numpy()) for i in range(0, n, 500)],
        n)
    np.testing.assert_array_equal(port._centroids.numpy(),
                                  np.asarray(jax_index._centroids))
    agree = np.mean(port._leaf_rows.numpy()
                    == np.asarray(jax_index._leaf_rows))
    assert agree > 0.99, agree
