"""The port's `Multitask` against the JAX package's, on the CPU.

Same weights (through `utils.convert`) and NumPy batches; 3 Adagrad
steps of each package's `Trainer`, unfused and `fused=True` (the port's
K2 wrapper runs its plain twin on CPU tensors; the JAX task takes its
own CPU route), with the metrics; forward losses under the tutorial's
three weightings; `predict_rating`; the `convert` round trip.

Tolerances: as `test_torch_trainer.py` (`optax.adagrad(lr)` ↔
`torch.optim.Adagrad(lr, initial_accumulator_value=0.1, eps=0)`, ≤ 5e-7
relative a step): losses and metrics to rtol 1e-5, weights to rtol 1e-5
and atol 2e-6 after 3 steps; forward values to rtol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommenders_tpu import models as jax_models
from recommenders_tpu.layers import blocks as jax_blocks
from recommenders_tpu_torch import models
from recommenders_tpu_torch.models import multitask
from recommenders_tpu_torch.models import ranking
from recommenders_tpu_torch.utils import convert

USERS, ITEMS, DIM, B = 64, 128, 16, 32
LR = 0.2
STEPS = 3


def _batches(seed, count):
    rng = np.random.RandomState(seed)
    return [{"user_id": rng.randint(0, USERS, B).astype(np.int32),
             "movie_id": rng.randint(0, ITEMS, B).astype(np.int32),
             "user_rating": rng.randint(1, 6, B).astype(np.float32),
             "sample_weight": rng.rand(B).astype(np.float32) + 0.5}
            for _ in range(count)]


@functools.lru_cache(maxsize=None)
def _jax_multitask(fused, retrieval_weight=1.0, rating_weight=1.0):
    """The JAX trainer and its initial state as NumPy copies, once per
    process (its step donates the state it is given)."""
    model = jax_models.Multitask(
        query_tower=lambda: jax_models.EmbeddingTower(USERS, DIM, (DIM,)),
        candidate_tower=lambda: jax_models.EmbeddingTower(ITEMS, DIM),
        rating_head=lambda: jax_blocks.MLP(units=(32, 16, 1)),
        retrieval_weight=retrieval_weight, rating_weight=rating_weight,
        fused=fused)
    trainer = jax_models.Trainer(model, optax.adagrad(LR))
    sample = {k: jnp.asarray(v) for k, v in _batches(0, 1)[0].items()}
    return trainer, jax.tree.map(
        np.array, trainer.init(jax.random.PRNGKey(0), sample))


def _port_model(params, fused, retrieval_weight=1.0, rating_weight=1.0,
                rating_head=True):
    model = models.Multitask(
        models.EmbeddingTower(USERS, DIM, (DIM,), device="cpu"),
        models.EmbeddingTower(ITEMS, DIM, device="cpu"),
        rating_head=(ranking.mlp_stack((32, 16, 1))(2 * DIM, "cpu")
                     if rating_head else None),
        retrieval_weight=retrieval_weight, rating_weight=rating_weight,
        fused=fused)
    if params is not None:
        convert.load_flax_params(model, params)
    return model


def _pair(fused):
    jtrainer, jstate = _jax_multitask(fused)
    jstate = jax.tree.map(jnp.array, jstate)
    model = _port_model(jax.tree.map(np.asarray, jstate.params), fused)
    ttrainer = models.Trainer(model, lambda p: torch.optim.Adagrad(
        p, lr=LR, initial_accumulator_value=0.1, eps=0.0))
    return jtrainer, jstate, ttrainer, ttrainer.init()


@pytest.mark.parametrize("fused", [False, True])
def test_three_steps_and_metrics_match_jax(fused):
    jtrainer, jstate, ttrainer, tstate = _pair(fused)
    for batch in _batches(1, STEPS):
        jstate, jl = jtrainer.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tl = ttrainer.train_step(tstate, batch)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = jax.tree.map(np.asarray, jstate.params)
    got = convert.to_flax_params(ttrainer.model)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-6,
                                   err_msg=jax.tree_util.keystr(path))
    want = jtrainer.metric_results(jstate)
    got = ttrainer.metric_results(tstate)
    assert set(got) == set(want) == {
        "rating_rmse", "batch_top_10_categorical_accuracy", "loss",
        "regularization_loss", "total_loss"}
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    top10 = tstate.metric_states["batch_top_10_categorical_accuracy"]
    if fused:   # The logits never exist: the state is the initial one.
        assert all(float(v) == 0.0 for v in top10.values())
    else:
        assert float(sum(top10.values())) > 0


@pytest.mark.parametrize("weights", [(1.0, 1.0), (0.0, 1.0), (1.0, 0.0)])
def test_forward_losses_and_ratings_match_jax(weights):
    jtrainer, jstate = _jax_multitask(False)
    params = jax.tree.map(np.asarray, jstate.params)
    jmodel = jax_models.Multitask(
        query_tower=lambda: jax_models.EmbeddingTower(USERS, DIM, (DIM,)),
        candidate_tower=lambda: jax_models.EmbeddingTower(ITEMS, DIM),
        rating_head=lambda: jax_blocks.MLP(units=(32, 16, 1)),
        retrieval_weight=weights[0], rating_weight=weights[1])
    batch = _batches(2, 1)[0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jaux = jmodel.apply({"params": params}, jbatch,
                               method=jmodel.compute_loss)
    jrating = jmodel.apply({"params": params}, jbatch,
                           method=jmodel.predict_rating)
    model = _port_model(params, False, *weights)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, aux = model.compute_loss(tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for task in ("retrieval", "rating"):
        np.testing.assert_allclose(float(aux[task].loss),
                                   float(jaux[task].loss), rtol=1e-5)
    np.testing.assert_allclose(model.predict_rating(tbatch).detach().numpy(),
                               np.asarray(jrating), rtol=1e-5, atol=1e-6)


def test_default_rating_head_and_convert_round_trip():
    model = _port_model(None, False, rating_head=False)
    assert [tuple(layer.weight.shape) for layer in model.rating_head.layers
            ] == [(256, 2 * DIM), (128, 256), (1, 128)]
    assert isinstance(model, multitask.Multitask)
    _, jstate = _jax_multitask(False)
    params = jax.tree.map(np.asarray, jstate.params)
    model = _port_model(params, False)
    back = convert.to_flax_params(model)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree_util.tree_leaves(back)):
        assert np.array_equal(g, w), jax.tree_util.keystr(path)
