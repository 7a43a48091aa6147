"""`models.Trainer(mesh=...)` on four gloo ranks: data parallelism whose
step equals the global batch's step, against the JAX `Trainer` on a
4-device mesh and the port's one-device `Trainer`.

The listwise case holds a `tasks.Ranking(loss_fn=listwise.*)` model
with per-list weights (a weighted mean, sum(w·l) / sum(w), which no
rank can take from its own slice) to the JAX trainer at the same
tolerances.

Tolerances: losses to rtol 1e-5 and parameters to rtol 1e-4 / atol 1e-6
of the JAX trainer after three SGD steps (XLA and PyTorch sum the
gradients in other orders); against the port's one-device trainer,
losses to rtol 1e-5 and parameters to rtol 1e-5 / atol 1e-6 (the
gradient sum over ranks adds the same terms in another grouping, which
moves a near-zero weight by an absolute 1e-7). The in-batch top-k
metrics are counts: equal.
"""

import dataclasses

import flax.linen as nn
import jax
import numpy as np
import optax
import pytest

from recommenders_tpu import models as jax_models
from recommenders_tpu import tasks as jax_tasks
from recommenders_tpu.parallel import mesh as jax_mesh
from recommenders_tpu.tasks import listwise as jax_listwise
from recommenders_tpu_torch.utils import convert

import torch_rank_workers as workers
from test_torch_pooled_negatives import _batch, _jax_model, _params
from torch_threads import torch_threads  # noqa: F401 (autouse)

LR = 0.5
RANKING_FCS = (("c0", "t0", 2000), ("c1", "t1", 300), ("c2", "t2", 900))


def _ranking_batches(steps=3, n=32):
    rng = np.random.RandomState(9)
    out = []
    for _ in range(steps):
        batch = {f"c{i}": rng.randint(0, v, n).astype(np.int64)
                 for i, (_, _, v) in enumerate(RANKING_FCS)}
        batch["dense_features"] = rng.normal(size=(n, 4)).astype(
            np.float32)
        batch["clicked"] = (rng.rand(n) < 0.3).astype(np.float32)
        out.append(batch)
    return out


LISTWISE = ("softmax_listwise", "list_mle")
LISTWISE_LR = 0.3


class _JaxListwise(jax_models.Model):
    loss_name: str

    def setup(self):
        self.dense = nn.Dense(1)
        self.task = jax_tasks.Ranking(
            loss_fn=getattr(jax_listwise, self.loss_name))

    def compute_loss(self, batch, training=False):
        scores = self.dense(batch["features"])[..., 0]
        return self.task(batch["labels"], scores, batch["weight"]).loss


def _listwise_batches(steps=3, n=32, lists=6, features=5):
    rng = np.random.RandomState(13)
    return [{"features": rng.normal(size=(n, lists, features)).astype(
                 np.float32),
             "labels": rng.randint(0, 4, (n, lists)).astype(np.float32),
             "weight": rng.uniform(0.1, 3.0, n).astype(np.float32)}
            for _ in range(steps)]


def _listwise_params(features=5):
    rng = np.random.RandomState(14)
    return (rng.normal(size=(features, 1)).astype(np.float32) * 0.5,
            rng.normal(size=(1,)).astype(np.float32) * 0.1)


@pytest.fixture(scope="module")
def ranks():
    _, params = _params(3)
    batches = [_batch(seed=s) for s in (3, 4, 5)]
    ragged = [_batch(n=63, seed=6)]
    cases = [
        ("meshed_trainer", ((4,), params, batches, LR)),
        ("meshed_trainer", (None, params, batches, LR)),
        ("meshed_trainer", ((4,), params, ragged, LR)),
        ("meshed_trainer", (None, params, ragged, LR)),
        ("meshed_ranking", ((2, 2), RANKING_FCS, 4, _ranking_batches(), 0.1,
                            11)),
        ("meshed_ranking", (None, RANKING_FCS, 4, _ranking_batches(), 0.1,
                            11)),
        ("meshed_refusals", ()),
    ] + [("meshed_listwise", ((4,), name) + _listwise_params()
          + (_listwise_batches(), LISTWISE_LR)) for name in LISTWISE]
    out = workers.cases((4, cases))
    return [[r[i] for r in out] for i in range(len(cases))]


def _close(got, want, **tol):
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, err_msg=name, **tol)


def test_meshed_trainer_matches_the_jax_trainer(ranks):
    params, _ = _params(3)
    mesh = jax_mesh.create_mesh(shape=(4,), axis_names=("data",),
                                devices=jax.devices()[:4])
    trainer = jax_models.Trainer(_jax_model(), optax.sgd(LR), mesh=mesh)
    state = trainer.init(jax.random.PRNGKey(0), _batch(seed=3))
    state = dataclasses.replace(state, params=params)
    losses = []
    for s in (3, 4, 5):
        state, loss = trainer.train_step(state, _batch(seed=s))
        losses.append(float(loss))
    port = workers._retrieval_model("cpu")
    convert.load_flax_params(port, jax.tree.map(np.asarray, state.params))
    want = {k: v.detach().numpy() for k, v in port.named_parameters()}
    for r in ranks[0]:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        _close(r["params"], want, rtol=1e-4, atol=1e-6)


def test_meshed_trainer_equals_the_one_device_global_step(ranks):
    base = ranks[1][0]
    for r in ranks[0]:
        np.testing.assert_allclose(r["losses"], base["losses"], rtol=1e-5)
        _close(r["params"], base["params"], rtol=1e-5, atol=1e-6)
        # Batch metrics: every query against the pooled candidates,
        # states summed over the data axis when read.
        for name, value in base["metrics"].items():
            if "top" in name:
                assert r["metrics"][name] == value, name
            else:
                np.testing.assert_allclose(r["metrics"][name], value,
                                           rtol=1e-5)


def test_a_ragged_batch_runs_whole_on_every_rank(ranks):
    for r in ranks[2]:
        assert r["losses"] == ranks[3][0]["losses"]
        _close(r["params"], ranks[3][0]["params"], rtol=0, atol=0)
        assert r["metrics"] == ranks[3][0]["metrics"]


def test_row_sharded_ranking_trains_as_one_device(ranks):
    """DLRM with its big tables row-sharded over `model` and the batch
    over `data`: the step of the whole model on the global batch."""
    base = ranks[5][0]
    for r in ranks[4]:
        np.testing.assert_allclose(r["losses"], base["losses"], rtol=1e-5)
        _close(r["params"], base["params"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", range(len(LISTWISE)))
def test_weighted_listwise_ranking_matches_the_jax_trainer(ranks, case):
    """A weighted listwise mean over the global batch: the gathered
    loss, not a sum of per-rank means."""
    name = LISTWISE[case]
    mesh = jax_mesh.create_mesh(shape=(4,), axis_names=("data",),
                                devices=jax.devices()[:4])
    batches = _listwise_batches()
    trainer = jax_models.Trainer(_JaxListwise(name),
                                 optax.sgd(LISTWISE_LR), mesh=mesh)
    state = trainer.init(jax.random.PRNGKey(0), batches[0])
    kernel, bias = _listwise_params()
    state = dataclasses.replace(state, params={
        "dense": {"kernel": kernel, "bias": bias}})
    losses = []
    for batch in batches:
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    dense = jax.tree.map(np.asarray, state.params["dense"])
    want = {"dense.weight": dense["kernel"].T, "dense.bias": dense["bias"]}
    for r in ranks[7 + case]:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        _close(r["params"], want, rtol=1e-4, atol=1e-6)


def test_a_loss_the_trainer_cannot_split_is_refused(ranks):
    for r in ranks[6]:
        assert "shard_tasks" in r["trainer"]
        assert "loss_fn" in r["retrieval"]
