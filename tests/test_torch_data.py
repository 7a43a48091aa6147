"""`data/` (vocab, preprocessing, MovieLens) against the JAX package's.

The host-side modules are NumPy in both packages, so for the same inputs
they must give identical arrays (tolerance: none). The preprocessing
transforms keep both of the JAX module's branches: a tensor follows the
`jax.Array` branch (float32), anything else the NumPy branch (float64
edges); each port branch must equal its JAX branch exactly, including
on values within a float32 ulp of an edge where the two branches
disagree with each other. `masked_mean` sums in another order than XLA:
within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from recommenders_tpu.data import movielens as jax_movielens
from recommenders_tpu.data import preprocessing as jax_pp
from recommenders_tpu.data import vocab as jax_vocab
from recommenders_tpu_torch import data
from recommenders_tpu_torch.data import movielens
from recommenders_tpu_torch.data import preprocessing as pp
from recommenders_tpu_torch.data import vocab


# --- vocab -----------------------------------------------------------------


def test_vocabulary_first_seen_order_encode_decode_match_jax():
    raw = np.asarray(["b", "a", "b", "c", "a", "zz", "c", "b"])
    ours, theirs = (vocab.build_vocabulary(raw),
                    jax_vocab.build_vocabulary(raw))
    assert ours.values == theirs.values == ("b", "a", "c", "zz")
    assert ours.size == theirs.size == 5
    queries = np.asarray([["a", "zz"], ["unknown", "b"]])
    np.testing.assert_array_equal(ours.encode(queries),
                                  theirs.encode(queries))
    assert ours.encode(queries).dtype == np.int32
    np.testing.assert_array_equal(ours.decode([0, 1, 4]),
                                  theirs.decode([0, 1, 4]))
    ints = vocab.build_vocabulary([7, 3, 7, 9])
    assert ints.values == jax_vocab.build_vocabulary([7, 3, 7, 9]).values
    features = {"user": raw, "score": np.arange(8.0)}
    got = vocab.encode_features(features, {"user": ours})
    want = jax_vocab.encode_features(features, {"user": theirs})
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert vocab.OOV_ID == jax_vocab.OOV_ID == 0


# --- preprocessing ----------------------------------------------------------


def _timestamps(n=2000, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(880_000_000, 893_000_000, n).astype(np.int64)


def test_normalizer_both_branches_match_jax():
    ts = _timestamps()
    ours, theirs = pp.Normalizer.adapt(ts), jax_pp.Normalizer.adapt(ts)
    assert (ours.mean, ours.std) == (theirs.mean, theirs.std)
    # Device branch: float32 arithmetic on the tensor's device.
    got = ours(torch.from_numpy(ts))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(theirs(jnp.asarray(ts))))
    # Host branch: NumPy.
    np.testing.assert_array_equal(ours(ts), theirs(ts))
    assert pp.Normalizer.adapt(np.ones(5)).std == 1.0


def test_discretizer_both_branches_match_jax_at_and_near_edges():
    ts = _timestamps(seed=1)
    ours = pp.Discretizer.adapt(ts, num_bins=100)
    theirs = jax_pp.Discretizer.adapt(ts, num_bins=100)
    assert ours.boundaries == theirs.boundaries
    assert ours.num_bins == theirs.num_bins
    edges = np.asarray(ours.boundaries)
    # Values on each edge, an f64 hair either side, one f32 ulp either
    # side, and outside the range.
    f32 = edges.astype(np.float32)
    probe = np.concatenate([
        edges, np.nextafter(edges, -np.inf), np.nextafter(edges, np.inf),
        np.nextafter(f32, np.float32(-np.inf)).astype(np.float64),
        np.nextafter(f32, np.float32(np.inf)).astype(np.float64),
        [edges[0] - 1e6, edges[-1] + 1e6], ts[:200].astype(np.float64),
    ])
    host = ours(probe)
    np.testing.assert_array_equal(host, theirs(probe))
    assert host.dtype == np.int32
    device = ours(torch.from_numpy(probe))
    assert device.dtype == torch.int32
    np.testing.assert_array_equal(device.numpy(),
                                  np.asarray(theirs(jnp.asarray(probe))))
    # The two branches disagree where f32 rounding moves a value across
    # an edge, as the JAX package's do.
    assert (device.numpy() != host).any()
    with pytest.raises(ValueError):
        pp.Discretizer.adapt(ts, num_bins=1)


def test_text_vectorizer_and_tokenize_match_jax():
    titles = ["Star Wars: Return!", "the Dark Knight", b"Star Trek",
              "Return of the King", "", "dark   STAR"]
    assert [pp.tokenize(str(t)) for t in titles[:2]] == [
        jax_pp.tokenize(str(t)) for t in titles[:2]]
    for max_tokens in (None, 5):
        ours = pp.TextVectorizer.adapt(titles, max_tokens=max_tokens)
        theirs = jax_pp.TextVectorizer.adapt(titles, max_tokens=max_tokens)
        assert ours.vocabulary == theirs.vocabulary
        assert ours.vocab_size == theirs.vocab_size
        np.testing.assert_array_equal(ours(titles, 3), theirs(titles, 3))
    with pytest.raises(ValueError):
        pp.TextVectorizer.adapt(titles, max_tokens=2)


def test_masked_mean_matches_jax():
    rng = np.random.RandomState(3)
    emb = rng.normal(size=(6, 4, 8)).astype(np.float32)
    tokens = rng.randint(0, 5, (6, 4)).astype(np.int32)
    tokens[0] = pp.PAD_ID                     # all padding pools to zero
    got = pp.masked_mean(torch.from_numpy(emb), torch.from_numpy(tokens))
    want = np.asarray(jax_pp.masked_mean(jnp.asarray(emb),
                                         jnp.asarray(tokens)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert not got[0].any()


# --- MovieLens --------------------------------------------------------------


def _assert_same_dataset(a, b):
    for field in ("user_ids", "movie_ids", "ratings", "timestamps"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)
    assert (a.num_users, a.num_movies) == (b.num_users, b.num_movies)


def test_synthetic_movielens_split_and_batched_are_identical():
    kwargs = dict(num_users=300, num_movies=500, num_interactions=5000,
                  num_clusters=7, seed=5)
    ours = data.synthetic_movielens(**kwargs)
    theirs = jax_movielens.synthetic_movielens(**kwargs)
    _assert_same_dataset(ours, theirs)
    for a, b in zip(ours.split(0.7, seed=3), theirs.split(0.7, seed=3)):
        _assert_same_dataset(a, b)
    for kw in (dict(shuffle=True, seed=4), dict(drop_remainder=False)):
        got, want = (data.batched(ours.as_dict(), 512, **kw),
                     jax_movielens.batched(theirs.as_dict(), 512, **kw))
        for _ in range(2):                    # two epochs: fresh shuffles
            ours_epoch, theirs_epoch = list(got()), list(want())
            assert len(ours_epoch) == len(theirs_epoch) > 1
            for g, w in zip(ours_epoch, theirs_epoch):
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])


def test_evaluate_matches_jax_with_ties():
    rng = np.random.RandomState(6)
    users = rng.normal(size=(40, 4)).astype(np.float32)
    movies = rng.normal(size=(60, 4)).astype(np.float32)
    movies[10:20] = movies[10]                # tied scores: argsort order
    test_u = rng.randint(0, 40, 300)
    test_m = rng.randint(0, 60, 300)
    train_u = rng.randint(0, 40, 200)
    train_m = rng.randint(0, 60, 200)
    for k in (5, 10):
        got = data.evaluate(users, movies, test_u, test_m, train_u, train_m,
                            k=k)
        want = jax_movielens.evaluate(users, movies, test_u, test_m, train_u,
                                      train_m, k=k)
        assert got == want
    assert data.evaluate(users, movies, test_u, test_m) == \
        jax_movielens.evaluate(users, movies, test_u, test_m)


def test_sample_listwise_matches_jax():
    ds = data.synthetic_movielens(num_users=50, num_movies=80,
                                  num_interactions=2000, seed=2)
    got = data.sample_listwise(ds.user_ids, ds.movie_ids, ds.ratings,
                               num_list_per_user=3, num_examples_per_list=5,
                               seed=9)
    want = jax_movielens.sample_listwise(
        ds.user_ids, ds.movie_ids, ds.ratings, num_list_per_user=3,
        num_examples_per_list=5, seed=9)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name,sep", [("u.data", "\t"),
                                      ("ratings.dat", "::")])
def test_load_movielens_reads_both_formats_as_jax_does(tmp_path, name, sep):
    ds = data.synthetic_movielens(num_users=40, num_movies=70,
                                  num_interactions=500, seed=8)
    lines = [sep.join(str(v) for v in (u + 1, m + 1, int(r), t))
             for u, m, r, t in zip(ds.user_ids, ds.movie_ids, ds.ratings,
                                   ds.timestamps)]
    path = tmp_path / name
    path.write_text("\n".join(lines) + "\n\n")
    got = data.load_movielens(str(path))
    _assert_same_dataset(got, jax_movielens.load_movielens(str(path)))
    np.testing.assert_array_equal(got.user_ids, ds.user_ids)
    np.testing.assert_array_equal(got.movie_ids, ds.movie_ids)
    np.testing.assert_array_equal(got.ratings, ds.ratings)
    np.testing.assert_array_equal(got.timestamps, ds.timestamps)
    sized = data.load_movielens(str(path), num_users=100, num_movies=200)
    assert (sized.num_users, sized.num_movies) == (100, 200)
    assert movielens.SyntheticMovieLens is data.SyntheticMovieLens
