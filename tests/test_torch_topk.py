"""Port parity for `ops/topk.py` (top_k, merge, padding, exclusion).

Seeded NumPy inputs go through the JAX package on the CPU and through the
port. The inputs are continuous draws, with no tied scores, so `lax.top_k` and `torch.topk`
must agree exactly on ids; scores are copied, not computed, so they must
agree exactly too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.ops import topk as jax_topk
from recommenders_tpu_torch.ops import topk


def _scores(q=6, m=40, seed=0):
    rng = np.random.RandomState(seed)
    scores = rng.normal(size=(q, m)).astype(np.float32)
    ids = rng.permutation(1000)[: q * m].reshape(q, m).astype(np.int32)
    return scores, ids


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_min_float_is_the_jax_value():
    assert np.float32(topk.MIN_FLOAT) == jax_topk.MIN_FLOAT


def test_top_k_and_take_along_rows():
    scores, ids = _scores()
    want_v, want_i = jax_topk.top_k(jnp.asarray(scores), 7)
    got_v, got_i = topk.top_k(torch.from_numpy(scores), 7)
    _eq((got_v, got_i), (want_v, want_i))
    _eq(
        [topk.take_along_rows(torch.from_numpy(ids), got_i)],
        [jax_topk.take_along_rows(jnp.asarray(ids), want_i)],
    )


@pytest.mark.parametrize("k", [5, 100])
def test_topk_merge(k):
    a, ia = _scores(m=30, seed=1)
    b, ib = _scores(m=20, seed=2)
    want = jax_topk.topk_merge(
        (jnp.asarray(a), jnp.asarray(ia)), (jnp.asarray(b), jnp.asarray(ib)),
        k,
    )
    got = topk.topk_merge(
        (torch.from_numpy(a), torch.from_numpy(ia)),
        (torch.from_numpy(b), torch.from_numpy(ib)), k,
    )
    assert got[0].shape == (6, min(k, 50))
    _eq(got, want)


@pytest.mark.parametrize("with_ids", [False, True])
def test_pad_corpus(with_ids):
    rng = np.random.RandomState(3)
    corpus = rng.normal(size=(130, 8)).astype(np.float32)
    ids = np.arange(1000, 1130, dtype=np.int32) if with_ids else None
    want = jax_topk.pad_corpus(
        jnp.asarray(corpus), None if ids is None else jnp.asarray(ids), 128
    )
    got = topk.pad_corpus(
        torch.from_numpy(corpus), None if ids is None
        else torch.from_numpy(ids), 128,
    )
    assert got[0].shape == (256, 8) and got[1].dtype == torch.int32
    _eq(got, want)


def test_exclude_returns_original_scores():
    scores, ids = _scores(q=4, m=30, seed=4)
    rng = np.random.RandomState(5)
    exclusions = np.stack(
        [rng.choice(ids[i], size=5, replace=False) for i in range(4)]
    )
    exclusions[0, 0] = -7  # Unknown ids exclude nothing.
    want = jax_topk.exclude(
        jnp.asarray(scores), jnp.asarray(ids), jnp.asarray(exclusions), 10
    )
    got = topk.exclude(
        torch.from_numpy(scores), torch.from_numpy(ids),
        torch.from_numpy(exclusions), 10,
    )
    _eq(got, want)
    for row, excl in zip(got[1].numpy(), exclusions):
        assert not set(row) & set(excl)
