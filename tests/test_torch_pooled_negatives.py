"""Pooled in-batch negatives on four gloo ranks: the step must equal the
global batch's step on one device (mirrors `tests/test_pooled_negatives.py`),
unfused and fused (K2's twin with B/4 queries and C = B candidates).

Tolerances: the pooled loss to rtol 1e-5 of the JAX model's global-batch
loss (sums of other shapes and orders); one SGD step of lr 1 to rtol 1e-4
/ atol 1e-6 of `params − grads` from JAX's autodiff, as the JAX test
holds its own pooled step; the fused step to rtol 1e-5 of the unfused.
"""

import jax
import numpy as np
import pytest

from recommenders_tpu import models as jax_models
from recommenders_tpu_torch.utils import convert

import torch_rank_workers as workers
from torch_threads import torch_threads  # noqa: F401 (autouse)


def _jax_model():
    return jax_models.TwoTowerRetrieval(
        query_tower=lambda: jax_models.EmbeddingTower(100, 16),
        candidate_tower=lambda: jax_models.EmbeddingTower(200, 16),
    )


def _batch(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return {"user_id": rng.randint(0, 100, n).astype(np.int64),
            "movie_id": rng.randint(0, 200, n).astype(np.int64)}


def _params(seed):
    """JAX params and the same weights as the port model's parameters."""
    batch = _batch(seed=seed)
    params = _jax_model().init(jax.random.PRNGKey(seed), batch,
                               method="compute_loss")["params"]
    port = workers._retrieval_model("cpu")
    convert.load_flax_params(port, jax.tree.map(np.asarray, params))
    return params, {k: v.detach().numpy().copy()
                    for k, v in port.named_parameters()}


def _synthetic(n=4096, seed=2):
    """Clustered interactions: users of a cluster like its movies."""
    rng = np.random.RandomState(seed)
    users = rng.randint(0, 100, n)
    movies = (users % 5) * 40 + rng.randint(0, 40, n)
    return {"user_id": users.astype(np.int64),
            "movie_id": movies.astype(np.int64)}


@pytest.fixture(scope="module")
def ranks():
    _, p0 = _params(0)
    _, p1 = _params(1)
    cases = [
        ("pooled_step", (p0, _batch(seed=0), 0.0, False, 1)),
        ("pooled_step", (p1, _batch(seed=1), 1.0, False, 1)),
        ("pooled_step", (p1, _batch(seed=1), 1.0, True, 1)),
        ("pooled_trainer", (_synthetic(), 256, 0.3)),
    ]
    out = workers.cases((4, cases))
    return [[r[i] for r in out] for i in range(len(cases))]


def test_pooled_loss_equals_single_device(ranks):
    """Sum-reduced in-batch CE over pooled candidates == full-batch CE."""
    params, _ = _params(0)
    oracle, _ = _jax_model().apply({"params": params}, _batch(seed=0),
                                   method="compute_loss")
    for r in ranks[0]:
        np.testing.assert_allclose(r["losses"][0], float(oracle), rtol=1e-5)


def test_pooled_gradients_match_single_device(ranks):
    params, _ = _params(1)
    batch = _batch(seed=1)

    def loss(p):
        return _jax_model().apply({"params": p}, batch,
                                  method="compute_loss")[0]

    grads = jax.grad(loss)(params)
    want = jax.tree.map(lambda p, g: np.asarray(p) - np.asarray(g), params,
                        grads)
    port = workers._retrieval_model("cpu")
    convert.load_flax_params(port, want)
    for r in ranks[1]:
        for name, value in port.named_parameters():
            np.testing.assert_allclose(r["params"][name],
                                       value.detach().numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)


def test_fused_pooled_step_matches_unfused(ranks):
    """`Retrieval(fused=True)`: K2's twin with 16 local queries against
    the 64 pooled candidates gives the unfused step."""
    for fused, unfused in zip(ranks[2], ranks[1]):
        np.testing.assert_allclose(fused["losses"], unfused["losses"],
                                   rtol=1e-5)
        for name, value in unfused["params"].items():
            np.testing.assert_allclose(fused["params"][name], value,
                                       rtol=1e-5, atol=1e-7)


def test_pooled_trainer_learns(ranks):
    for r in ranks[3]:
        assert r["losses"][-1] < r["losses"][0] * 0.9, r["losses"]
        assert r["losses"] == ranks[3][0]["losses"]


def test_pooled_trainer_evaluate_without_track_stats(ranks):
    for r in ranks[3]:
        assert r["track_stats"] is False
        assert set(r["evaluated"]) == {"total_loss"}
        assert np.isfinite(r["evaluated"]["total_loss"])
        assert np.isfinite(r["history"]["val_total_loss"])
