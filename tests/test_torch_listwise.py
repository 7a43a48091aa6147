"""The port's listwise losses against the JAX package, on the CPU.

Each loss of `tasks/listwise.py` (and both lambda weightings) on the
same NumPy lists, with ties in labels and scores, ragged lists by
`mask`, an all-masked list and per-list weights: values and gradients
with respect to the scores.

Tolerances: values to rtol 1e-5 and atol 1e-6, score gradients to rtol
1e-4 and atol 1e-6 (f32 sums over a list's pairs in another order).
ListMLE's suffix log-sum-exp is `torch.logcumsumexp` in the port and an
`associative_scan` of `logaddexp` in JAX: the same value to a tolerance,
not bit for bit (ROADMAP Queue C), held by the same limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.tasks import listwise as jax_listwise
from recommenders_tpu_torch.tasks import listwise
from torch_threads import torch_threads  # noqa: F401 (autouse)

B, L = 16, 8

LOSSES = ("softmax_listwise", "pairwise_logistic", "lambdarank",
          "list_mle", "approx_ndcg")


def _lists(seed, ragged, weighted):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 5, (B, L)).astype(np.float32)
    scores = rng.randn(B, L).astype(np.float32)
    scores[1, :4] = scores[1, 4:]               # tied scores
    mask = None
    if ragged:
        lengths = rng.randint(1, L + 1, B)
        lengths[2] = L
        mask = np.arange(L)[None, :] < lengths[:, None]
        mask[3] = False                          # an all-masked list
    weight = rng.rand(B).astype(np.float32) + 0.1 if weighted else None
    return labels, scores, mask, weight


def _port(name, labels, scores, mask, weight):
    s = torch.from_numpy(scores).requires_grad_(True)
    loss = getattr(listwise, name)(
        torch.from_numpy(labels), s,
        sample_weight=None if weight is None else torch.from_numpy(weight),
        mask=None if mask is None else torch.from_numpy(mask))
    loss.backward()
    return float(loss.detach()), s.grad.numpy()


def _jax(name, labels, scores, mask, weight):
    fn = getattr(jax_listwise, name)
    value, grad = jax.value_and_grad(
        lambda s: fn(labels, s, sample_weight=weight, mask=mask))(
            jnp.asarray(scores))
    return float(value), np.asarray(grad)


@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("ragged,weighted", [(False, False), (True, False),
                                             (True, True)])
def test_loss_and_score_grads_match_jax(name, ragged, weighted):
    inputs = _lists(0, ragged, weighted)
    got, got_grad = _port(name, *inputs)
    want, want_grad = _jax(name, *inputs)
    assert np.isfinite(got) and np.isfinite(got_grad).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["ndcg_lambda_weights",
                                  "dcg_lambda_weights"])
@pytest.mark.parametrize("ragged", [False, True])
def test_lambda_weights_match_jax_and_carry_no_gradient(name, ragged):
    labels, scores, mask, _ = _lists(1, ragged, False)
    s = torch.from_numpy(scores).requires_grad_(True)
    got = getattr(listwise, name)(
        torch.from_numpy(labels), s,
        mask=None if mask is None else torch.from_numpy(mask))
    want = getattr(jax_listwise, name)(labels, scores, mask=mask)
    assert not got.requires_grad
    assert tuple(got.shape) == (B, L, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def test_ranks_are_stable_among_tied_scores():
    """Equal scores rank in list order (a stable descending sort), and
    masked entries rank last, as `jnp.argsort(-key, stable=True)`."""
    labels = np.array([[3.0, 1.0, 2.0, 0.0]], np.float32)
    scores = np.zeros((1, 4), np.float32)
    mask = np.array([[True, True, False, True]])
    got = listwise.ndcg_lambda_weights(torch.from_numpy(labels),
                                       torch.from_numpy(scores),
                                       torch.from_numpy(mask))
    want = jax_listwise.ndcg_lambda_weights(labels, scores, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    gains = 2.0 ** labels[0] - 1
    gains[2] = 0.0
    ranks = np.array([1, 2, 4, 3])             # masked entry 2 last
    disc = 1 / np.log2(1 + ranks)
    ideal = np.sort(gains)[::-1] / np.log2(2 + np.arange(4))
    expect = (np.abs(gains[:, None] - gains[None])
              * np.abs(disc[:, None] - disc[None]) / ideal.sum())
    np.testing.assert_allclose(got[0].numpy(), expect, rtol=1e-5)


def test_list_mle_suffix_logsumexp_against_float64():
    """ListMLE over long lists with a wide score range: the port's
    `logcumsumexp` and JAX's `associative_scan` both stay within 1e-5 of
    a float64 sequential sum."""
    rng = np.random.RandomState(2)
    labels = rng.randint(0, 3, (4, 64)).astype(np.float32)
    scores = (rng.randn(4, 64) * 20).astype(np.float32)
    got = float(listwise.list_mle(torch.from_numpy(labels),
                                  torch.from_numpy(scores)))
    want = float(jax_listwise.list_mle(labels, scores))
    order = np.argsort(-labels, axis=1, kind="stable")
    s = np.take_along_axis(scores.astype(np.float64), order, 1)
    suffix = np.logaddexp.accumulate(s[:, ::-1], axis=1)[:, ::-1]
    exact = float(np.mean(np.mean(suffix - s, axis=1)))
    np.testing.assert_allclose(got, exact, rtol=1e-5)
    np.testing.assert_allclose(want, exact, rtol=1e-5)
