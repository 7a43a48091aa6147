"""The serving slice end to end: flax two-tower model → port → index.

A flax `TwoTowerRetrieval` (query tower with an MLP head (256, 128),
candidate tower without) is initialised in the JAX package; its params
carry across with `utils.convert.load_flax_params`. Candidate and query
embeddings must match the JAX model's to 1e-5 (f32 matmuls in another
sum order), and `Bucketed` top-100 through `query_fn=query_embeddings`
must return the same ids as the JAX `Bucketed` with the JAX model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_tpu.layers import factorized_top_k as jax_ftk
from recommenders_tpu.models import retrieval as jax_retrieval
from recommenders_tpu_torch.layers import factorized_top_k as ftk
from recommenders_tpu_torch.models import retrieval
from recommenders_tpu_torch.utils import convert
from torch_threads import torch_threads  # noqa: F401 (autouse)

USERS, ITEMS, DIM, MLP = 200, 4000, 128, (256, 128)
EMB_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jax_model = jax_retrieval.TwoTowerRetrieval(
        query_tower=lambda: jax_retrieval.EmbeddingTower(
            USERS, DIM, mlp_units=MLP
        ),
        candidate_tower=lambda: jax_retrieval.EmbeddingTower(ITEMS, DIM),
    )
    batch = {"user_id": jnp.arange(4), "movie_id": jnp.arange(4)}
    params = jax_model.init(
        jax.random.PRNGKey(0), batch, method="compute_loss"
    )["params"]
    params = jax.tree.map(np.asarray, params)
    model = retrieval.TwoTowerRetrieval(
        retrieval.EmbeddingTower(USERS, DIM, MLP, device="cpu"),
        retrieval.EmbeddingTower(ITEMS, DIM, device="cpu"),
    )
    convert.load_flax_params(model, params)
    return jax_model, params, model


def _jax_apply(jax_model, params, method, batch):
    return np.asarray(jax_model.apply(
        {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
        method=method,
    ))


def test_embeddings_match_jax(models):
    jax_model, params, model = models
    items = {"movie_id": np.arange(ITEMS, dtype=np.int32)}
    # Negative ids (padding) clamp to row 0 in both packages.
    users = {"user_id": np.array([0, 5, 199, -1, 17], dtype=np.int32)}
    with torch.no_grad():
        got_c = model.candidate_embeddings(
            {"movie_id": torch.from_numpy(items["movie_id"])}
        )
        got_q = model.query_embeddings(
            {"user_id": torch.from_numpy(users["user_id"])}
        )
    np.testing.assert_allclose(
        got_c.numpy(),
        _jax_apply(jax_model, params, "candidate_embeddings", items),
        **EMB_TOL,
    )
    np.testing.assert_allclose(
        got_q.numpy(),
        _jax_apply(jax_model, params, "query_embeddings", users),
        **EMB_TOL,
    )


def test_bucketed_serving_matches_jax(models):
    jax_model, params, model = models
    items = {"movie_id": np.arange(ITEMS, dtype=np.int32)}
    users = np.arange(0, USERS, 8, dtype=np.int32)
    jax_index = jax_ftk.Bucketed(
        query_fn=lambda ids: jax_model.apply(
            {"params": params}, {"user_id": ids}, method="query_embeddings"
        ),
        k=100, buckets=512, chunk=1024, query_tile=32,
    ).index(jnp.asarray(
        _jax_apply(jax_model, params, "candidate_embeddings", items)
    ))
    with torch.no_grad():
        index = ftk.Bucketed(
            query_fn=lambda ids: model.query_embeddings({"user_id": ids}),
            k=100, buckets=512, chunk=1024, query_tile=32, device="cpu",
        ).index(model.candidate_embeddings(
            {"movie_id": torch.from_numpy(items["movie_id"])}
        ))
        got_s, got_i = index(torch.from_numpy(users))
    want_s, want_i = jax_index(jnp.asarray(users))
    assert got_i.shape == (len(users), 100)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **EMB_TOL)


def test_params_round_trip(models):
    _, params, model = models
    back = convert.to_flax_params(model)
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, array in flat_in:
        np.testing.assert_array_equal(flat_out[path], array)


def test_convert_rejects_missing_extra_and_misshapen(models):
    _, params, model = models
    missing = {k: v for k, v in params.items() if k != "_candidate"}
    with pytest.raises(ValueError, match="missing.*candidate_tower"):
        convert.load_flax_params(model, missing)
    extra = dict(params, _extra={"Dense_0": {"kernel": np.zeros((2, 2))}})
    with pytest.raises(ValueError, match="extra.*_extra"):
        convert.load_flax_params(model, extra)
    small = retrieval.TwoTowerRetrieval(
        retrieval.EmbeddingTower(USERS, DIM, MLP, device="cpu"),
        retrieval.EmbeddingTower(ITEMS - 1, DIM, device="cpu"),
    )
    with pytest.raises(ValueError, match="shape"):
        convert.load_flax_params(small, params)
