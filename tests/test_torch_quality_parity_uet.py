"""`tools/quality_parity.py`'s unified-embedding study against the JAX package.

A small run of `tools/reference_parity_ctr.py`'s three-way study
(collisionless, hash trick, `UnifiedEmbedding`): the same data (the
port's `make_uet` gives the JAX tool's arrays), the JAX model's initial
weights carried into the port's, the same batches in the same order.
Tolerances: per-epoch losses to rtol 1e-4 (`optax.adam` takes its bias
corrections in f32, ~1e-5 of an update); AUC within 0.005.
"""

import importlib.util
import os
from pathlib import Path
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from recommenders_tpu import data as jax_data
from recommenders_tpu import metrics as jax_metrics
from recommenders_tpu import models as jax_models
from recommenders_tpu import tasks as jax_tasks
from recommenders_tpu.embedding import unified as jax_unified
from recommenders_tpu.ops import hashing as jax_hashing
from recommenders_tpu_torch.tools import quality_parity as qp
from recommenders_tpu_torch.utils import convert
from torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _args():
    return qp.parse_args(["--device", "cpu", "--examples", "12000",
                          "--uet-epochs", "2", "--batch", "4096"])


def _jax_fit(model, optimizer, batches, seed, epochs):
    """The JAX tool's training: init on the factory's first batch, fit.
    Returns (trainer, state, initial params as NumPy, per-epoch losses)."""
    trainer = jax_models.Trainer(model, optimizer)
    state = trainer.init(jax.random.PRNGKey(seed), next(batches()))
    params = jax.tree.map(np.array, fnn.meta.unbox(state.params))
    state, history = trainer.fit(state, batches, epochs=epochs,
                                 verbose=False)
    return trainer, state, params, [e["loss"] for e in history["epochs"]]


def _load_dense(module, params):
    module.weight.data.copy_(convert.tensor_from_numpy(params["kernel"].T))
    module.bias.data.copy_(convert.tensor_from_numpy(params["bias"]))


class _JaxUET(jax_models.Model):
    """`tools/reference_parity_ctr.py::run_ours_uet`'s `Base`."""

    kind: str = "collisionless"

    def setup(self):
        if self.kind == "unified":
            config = jax_unified.UnifiedEmbeddingConfig(
                buckets_per_table=sum(qp.UET_BUCKETS.values()),
                dim_per_table=qp.UET_DIM // 2, num_tables=2, name="unified")
            for name in qp.UET_VOCABS:
                config.add_feature(name, 2)
            self.embedding = jax_unified.UnifiedEmbedding(
                config=config, shard_tables=False)
        else:
            self.embs = {
                name: fnn.Embed(qp.UET_BUCKETS[name] if self.kind == "hash"
                                else v, qp.UET_DIM, name=f"emb_{name}")
                for name, v in qp.UET_VOCABS.items()}
        self.head = fnn.Sequential([fnn.Dense(128), fnn.relu, fnn.Dense(64),
                                    fnn.relu, fnn.Dense(1)])
        self.task = jax_tasks.Ranking()

    def compute_loss(self, batch, training=False):
        if self.kind == "unified":
            parts = self.embedding({n: batch[n] for n in qp.UET_VOCABS})
        else:
            parts = []
            for i, name in enumerate(qp.UET_VOCABS):
                ids = batch[name]
                if self.kind == "hash":
                    ids = jax_hashing.hash_bucket(ids, qp.UET_BUCKETS[name],
                                                  (i, 0))
                parts.append(self.embs[name](ids))
        pred = jax.nn.sigmoid(self.head(jnp.concatenate(parts, -1))[:, 0])
        out = self.task(batch["label"], pred)
        return out.loss, {"labels": out.labels,
                          "predictions": out.predictions}

    def metrics(self):
        return {"auc": jax_metrics.AUC()}

    def update_metrics(self, states, batch, aux):
        return {"auc": jax_metrics.AUC().update(
            states["auc"], aux["labels"], aux["predictions"])}


def _jax_tool():
    """`tools/reference_parity_ctr.py` as a module, its environment
    settings undone after the import."""
    spec = importlib.util.spec_from_file_location(
        "reference_parity_ctr", ROOT / "tools" / "reference_parity_ctr.py")
    module = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):
        spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kind", qp.UET_KINDS)
def test_uet_matches_jax_from_the_same_weights(kind):
    args = _args()
    train, test = qp.make_uet(args)
    tool = _jax_tool()
    assert tool.UET_VOCABS == qp.UET_VOCABS
    assert tool.UET_BUCKETS == qp.UET_BUCKETS
    for ours, theirs in zip(jax.tree.leaves((train, test)),
                            jax.tree.leaves(tool.make_uet(args))):
        np.testing.assert_array_equal(ours, theirs)

    def batch(split):
        return {**split[0], "label": split[1]}

    trainer, state, params, jax_losses = _jax_fit(
        _JaxUET(kind=kind), optax.adam(args.uet_lr), jax_data.batched(
            batch(train), args.batch, shuffle=True, seed=args.seed),
        args.seed, args.uet_epochs)
    want = trainer.evaluate(state, jax_data.batched(
        batch(test), args.batch, drop_remainder=False))

    port = qp.uet_model(kind, args)
    if kind == "unified":
        convert.load_flax_params(port.embedding, params["embedding"])
    else:
        for name in qp.UET_VOCABS:
            port.embs[name].weight.data.copy_(convert.tensor_from_numpy(
                params[f"emb_{name}"]["embedding"]))
    for i, layer in enumerate(port.head.layers):
        _load_dense(layer, params["head"][f"layers_{2 * i}"])
    got = qp.train_uet(port, train, test, args)
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-4)
    assert abs(got["auc"] - want["auc"]) <= 0.005
