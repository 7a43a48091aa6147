"""`tools/quality_parity.py` against the JAX package, from the same weights.

Small runs of the head-to-head tools' retrieval and ranking studies (the
unified-embedding study is `tests/test_torch_quality_parity_uet.py`):
the same synthetic data (the port's `data` makes the JAX package's
arrays), the JAX model's initial weights carried into the port's, the
same batches in the same order. Tolerances: per-epoch losses to rtol
1e-4 (`optax.adagrad` and torch's differ by ≤ 5e-7 an update); top-k
accuracies within 0.005, RMSE within 1e-3.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommenders_tpu import data as jax_data
from recommenders_tpu import models as jax_models
from recommenders_tpu import tasks as jax_tasks
from recommenders_tpu.metrics import base as jax_metrics_base
from recommenders_tpu.models.retrieval import evaluate_with_corpus_metrics
from recommenders_tpu_torch import models
from recommenders_tpu_torch.layers import blocks
from recommenders_tpu_torch.tools import quality_parity as qp
from recommenders_tpu_torch.utils import convert

def _args():
    return qp.parse_args(["--device", "cpu", "--interactions", "25000",
                          "--epochs", "2", "--batch", "4096",
                          "--examples", "12000", "--uet-epochs", "2"])


def _keras_uniform(key, shape, dtype=jnp.float32):
    return jax.random.uniform(key, shape, dtype, -0.05, 0.05)


def _jax_fit(model, optimizer, batches, seed, epochs):
    """The JAX tools' training: init on the factory's first batch, fit.
    Returns (trainer, state, initial params as NumPy, per-epoch losses)."""
    trainer = jax_models.Trainer(model, optimizer)
    state = trainer.init(jax.random.PRNGKey(seed), next(batches()))
    params = jax.tree.map(np.array, fnn.meta.unbox(state.params))
    state, history = trainer.fit(state, batches, epochs=epochs,
                                 verbose=False)
    return trainer, state, params, [e["loss"] for e in history["epochs"]]


def test_defaults_are_the_tools():
    args = qp.parse_args([])
    assert (args.users, args.movies, args.interactions, args.epochs,
            args.dim, args.batch, args.lr, args.seed) == (
        943, 1682, 100_000, 3, 32, 8192, 0.1, 42)
    assert args.uet_lr == 0.01
    # The bounds are constants, not options: no argument moves them.
    assert (qp.BOUNDS["top_100"], qp.BOUNDS["rmse"], qp.BOUNDS["top_10"],
            qp.BOUNDS["unified"], qp.UET_MARGIN) == (0.003, 0.003, 0.01,
                                                     0.015, 0.10)
    assert not any("tolerance" in k or "margin" in k for k in vars(args))
    # The unified-embedding study runs at the size of the run behind its
    # recorded means (docs/PARITY_HEAD_TO_HEAD.md:15), not the JAX tool's
    # own 120,000 examples / 4 epochs.
    assert (args.examples, args.uet_epochs) == (200_000, 8)
    assert args.device == "cuda"


@pytest.mark.parametrize("fused", [False, True])
def test_retrieval_matches_jax_from_the_same_weights(fused):
    args = _args()
    train, test = qp.movielens_split(args)
    jax_train, jax_test = jax_data.synthetic_movielens(
        num_users=args.users, num_movies=args.movies,
        num_interactions=args.interactions, num_clusters=20,
        seed=args.seed).split(train_fraction=0.8, seed=17)
    np.testing.assert_array_equal(train.movie_ids, jax_train.movie_ids)

    model = jax_models.TwoTowerRetrieval(
        query_tower=lambda: jax_models.EmbeddingTower(
            train.num_users, args.dim, embedding_init=_keras_uniform),
        candidate_tower=lambda: jax_models.EmbeddingTower(
            train.num_movies, args.dim, embedding_init=_keras_uniform))
    trainer, state, params, jax_losses = _jax_fit(
        model, optax.adagrad(args.lr), jax_data.batched(
            jax_train.as_dict(), args.batch, shuffle=True, seed=args.seed),
        args.seed, args.epochs)
    want = evaluate_with_corpus_metrics(
        trainer, state, jax_data.batched(jax_test.as_dict(), args.batch),
        {"movie_id": np.arange(train.num_movies, dtype=np.int32)},
        ks=(10, 50, 100))

    port = qp.retrieval_model(train.num_users, train.num_movies, args,
                              fused=fused)
    for tower in (port.query_tower, port.candidate_tower):
        w = tower.embedding.weight.detach()
        assert float(w.abs().max()) <= 0.05 and float(w.std()) > 0.02
    convert.load_flax_params(port, params)
    got = qp.train_retrieval(port, train, test, args)
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-4)
    for k in (10, 50, 100):
        assert abs(got[f"top_{k}"] - want[
            f"factorized_top_k/top_{k}_categorical_accuracy"]) <= 0.005


class _JaxRatingModel(jax_models.Model):
    """`tools/reference_parity.py::run_ours_ranking`'s RatingModel."""

    num_users: int
    num_movies: int
    dim: int

    def setup(self):
        self.user_emb = fnn.Embed(self.num_users, self.dim,
                                  embedding_init=_keras_uniform)
        self.movie_emb = fnn.Embed(self.num_movies, self.dim,
                                   embedding_init=_keras_uniform)
        self.dense1 = fnn.Dense(64)
        self.dense2 = fnn.Dense(1)
        self.task = jax_tasks.Ranking(loss_fn=jax_tasks.mean_squared_error)

    def compute_loss(self, batch, training=False):
        x = jnp.concatenate([self.user_emb(batch["user_id"]),
                             self.movie_emb(batch["movie_id"])], axis=-1)
        pred = self.dense2(fnn.relu(self.dense1(x)))[:, 0]
        out = self.task(batch["rating"], pred)
        return out.loss, {"ranking": out}

    def metrics(self):
        return {"rmse": jax_metrics_base.RootMeanSquaredError()}

    def update_metrics(self, states, batch, aux):
        out = aux["ranking"]
        return {"rmse": jax_metrics_base.RootMeanSquaredError().update(
            states["rmse"], out.labels, out.predictions)}


def _load_dense(module, params):
    module.weight.data.copy_(convert.tensor_from_numpy(params["kernel"].T))
    module.bias.data.copy_(convert.tensor_from_numpy(params["bias"]))


def test_ranking_matches_jax_from_the_same_weights():
    args = _args()
    train, test = qp.movielens_split(args)
    trainer, state, params, jax_losses = _jax_fit(
        _JaxRatingModel(train.num_users, train.num_movies, args.dim),
        optax.adagrad(args.lr), jax_data.batched(
            train.as_dict(), args.batch, shuffle=True, seed=args.seed),
        args.seed, args.epochs)
    want = trainer.evaluate(state, jax_data.batched(test.as_dict(),
                                                    args.batch))

    port = qp.ranking_model(train.num_users, train.num_movies, args)
    port.user_emb.weight.data.copy_(convert.tensor_from_numpy(
        params["user_emb"]["embedding"]))
    port.movie_emb.weight.data.copy_(convert.tensor_from_numpy(
        params["movie_emb"]["embedding"]))
    _load_dense(port.dense1, params["dense1"])
    _load_dense(port.dense2, params["dense2"])
    got = qp.train_ranking(port, train, test, args)
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-4)
    assert abs(got["rmse"] - want["rmse"]) <= 1e-3


def test_quality_failures_reads_each_bound():
    good = {"retrieval": {k: qp.RECORDED[k] for k in
                          ("top_10", "top_50", "top_100")},
            "ranking": {"rmse": qp.RECORDED["rmse"] + 0.0029},
            "uet": {k: qp.RECORDED[k] for k in qp.UET_KINDS}}
    assert qp.quality_failures(good) == []
    bad = {**good, "retrieval fused": {"top_100": qp.RECORDED["top_100"]
                                       - 0.0031},
           "uet": {**good["uet"], "hash": qp.RECORDED["collisionless"]
                   - 0.05}}
    failures = qp.quality_failures(bad)
    assert len(failures) == 4, failures      # top-100, hash AUC, 2 margins


def test_embedding_tower_embedding_init():
    """`embedding_init` fills the table in place (Keras-uniform stays in
    ±0.05); without it the draws are the default truncated normal, the
    same for a fixed generator as before the option existed; `convert`
    still carries a flax tower's weights."""
    tower = models.EmbeddingTower(
        500, 16, mlp_units=(8,), device="cpu",
        generator=torch.Generator().manual_seed(1),
        embedding_init=qp.keras_uniform_)
    w = tower.embedding.weight.detach()
    assert float(w.abs().max()) <= 0.05 and float(w.std()) > 0.025
    default = models.EmbeddingTower(500, 16, device="cpu",
                                    generator=torch.Generator().manual_seed(1))
    want = torch.empty(500, 16)
    blocks.truncated_normal_(want, 16 ** -0.5,
                             torch.Generator().manual_seed(1))
    assert torch.equal(default.embedding.weight.detach(), want)
    flax_tower = jax_models.EmbeddingTower(500, 16, mlp_units=(8,),
                                           embedding_init=_keras_uniform)
    params = jax.tree.map(np.asarray, flax_tower.init(
        jax.random.PRNGKey(0), jnp.zeros((2,), jnp.int32))["params"])
    convert.load_flax_params(tower, params)
    np.testing.assert_array_equal(tower.embedding.weight.detach().numpy(),
                                  params["Embed_0"]["embedding"])
