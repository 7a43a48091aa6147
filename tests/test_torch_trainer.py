"""The port's `Trainer` with a `TwoTowerRetrieval` against the JAX
`Trainer`, on the CPU.

Each JAX trainer is built once per module (a module-scoped fixture per
optimizer); its initial weights are carried into the port's model with
`utils.convert`, and both train on the same NumPy batches.

Optimizers and tolerances:
  - `optax.sgd(lr)` ↔ `torch.optim.SGD(lr)`: the same update; losses to
    rtol 1e-5, weights to rtol 1e-5 and atol 1e-6 after 3 steps (f32
    matmuls in another order);
  - `optax.adagrad(lr)` ↔ `torch.optim.Adagrad(lr,
    initial_accumulator_value=0.1, eps=0)`: optax divides by
    sqrt(acc + 1e-7), torch by sqrt(acc), with acc ≥ 0.1, so one update
    differs by at most 5e-7 relative; losses to rtol 1e-5, weights to
    rtol 1e-5 and atol 2e-6 after 3 steps;
  - metric results (batch top-k accuracies, loss means) to rtol 1e-5;
    corpus accuracies (counts of 0/1 over the same ids) equal within
    1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommenders_tpu import models as jax_models
from recommenders_tpu.layers import factorized_top_k as jax_ftk
from recommenders_tpu.metrics import factorized_top_k as jax_ftk_metric
from recommenders_tpu_torch import models
from recommenders_tpu_torch.layers import factorized_top_k
from recommenders_tpu_torch.metrics import factorized_top_k as ftk_metric
from recommenders_tpu_torch.utils import convert

USERS, ITEMS, DIM, B = 64, 128, 16, 32
LR = {"sgd": 0.5, "adagrad": 0.3}
STEPS = 3


def _batches(seed, count, exclusions=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        batch = {"user_id": rng.randint(0, USERS, B).astype(np.int32),
                 "movie_id": rng.randint(0, ITEMS, B).astype(np.int32)}
        if exclusions:
            batch["seen"] = rng.randint(0, ITEMS, (B, 3)).astype(np.int32)
        out.append(batch)
    return out


def _jax_model(**kw):
    return jax_models.TwoTowerRetrieval(
        query_tower=lambda: jax_models.EmbeddingTower(USERS, DIM, (DIM,)),
        candidate_tower=lambda: jax_models.EmbeddingTower(ITEMS, DIM),
        query_key="user_id", candidate_key="movie_id", **kw)


def _port_model(**kw):
    return models.TwoTowerRetrieval(
        models.EmbeddingTower(USERS, DIM, (DIM,), device="cpu"),
        models.EmbeddingTower(ITEMS, DIM, device="cpu"),
        query_key="user_id", candidate_key="movie_id", **kw)


def _optimizers(kind):
    if kind == "sgd":
        return (optax.sgd(LR["sgd"]),
                lambda p: torch.optim.SGD(p, lr=LR["sgd"]))
    return (optax.adagrad(LR["adagrad"]),
            lambda p: torch.optim.Adagrad(p, lr=LR["adagrad"],
                                          initial_accumulator_value=0.1,
                                          eps=0.0))


def _pair(kind="sgd", track_stats=True, **model_kw):
    """(JAX trainer, its state, port trainer, its state), same weights."""
    jopt, topt = _optimizers(kind)
    jtrainer = jax_models.Trainer(_jax_model(**model_kw), jopt,
                                  track_stats=track_stats)
    sample = {k: jnp.asarray(v) for k, v in _batches(0, 1)[0].items()}
    jstate = jtrainer.init(jax.random.PRNGKey(0), sample)
    model = _port_model(**model_kw)
    convert.load_flax_params(model, jax.tree.map(np.asarray, jstate.params))
    ttrainer = models.Trainer(model, topt, track_stats=track_stats)
    tstate = ttrainer.init(torch.Generator().manual_seed(0))
    return jtrainer, jstate, ttrainer, tstate


def _assert_weights(jstate, model, atol):
    want = jax.tree.map(np.asarray, jstate.params)
    got = convert.to_flax_params(model)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module", params=["sgd", "adagrad"])
def trained(request):
    """Both trainers after STEPS steps on the same batches, with the
    losses each step returned."""
    kind = request.param
    jtrainer, jstate, ttrainer, tstate = _pair(kind)
    losses = []
    for batch in _batches(1, STEPS):
        jstate, jl = jtrainer.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tl = ttrainer.train_step(tstate, batch)
        losses.append((float(jl), float(tl)))
    return kind, jtrainer, jstate, ttrainer, tstate, losses


def test_three_steps_match_jax(trained):
    kind, _, jstate, ttrainer, tstate, losses = trained
    for jl, tl in losses:
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tstate.step == int(jstate.step) == STEPS
    _assert_weights(jstate, ttrainer.model,
                    atol=1e-6 if kind == "sgd" else 2e-6)


def test_metric_results_match_jax(trained):
    _, jtrainer, jstate, ttrainer, tstate, _ = trained
    want = jtrainer.metric_results(jstate)
    got = ttrainer.metric_results(tstate)
    assert set(got) == set(want) == {
        "batch_top_1_categorical_accuracy",
        "batch_top_10_categorical_accuracy", "loss",
        "regularization_loss", "total_loss"}
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   err_msg=name)


def test_state_holds_the_models_own_tensors(trained):
    _, _, _, ttrainer, tstate, _ = trained
    params = dict(ttrainer.model.named_parameters())
    assert set(tstate.params) == set(params)
    assert all(tstate.params[k] is params[k] for k in params)
    assert tstate.opt_state is ttrainer._optimizer
    assert tstate.generator is not None


def test_fit_with_validation_data_matches_jax_history():
    jtrainer, jstate, ttrainer, tstate = _pair("adagrad")
    train, val = _batches(2, 4), _batches(3, 2)
    jstate, jhist = jtrainer.fit(
        jstate, lambda: ({k: jnp.asarray(v) for k, v in b.items()}
                         for b in train),
        epochs=2, verbose=False, max_in_flight=3,
        validation_data=lambda: ({k: jnp.asarray(v) for k, v in b.items()}
                                 for b in val))
    tstate, thist = ttrainer.fit(tstate, lambda: iter(train), epochs=2,
                                 verbose=False, max_in_flight=3,
                                 validation_data=lambda: iter(val))
    assert len(thist["epochs"]) == len(jhist["epochs"]) == 2
    for want, got in zip(jhist["epochs"], thist["epochs"]):
        assert set(got) == set(want)
        assert "val_total_loss" in got and "examples_per_sec" in got
        assert got["examples_per_sec"] > 0
        for name in want:
            if name != "examples_per_sec":
                np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                           atol=1e-6, err_msg=name)
    assert tstate.step == 8
    _assert_weights(jstate, ttrainer.model, atol=2e-6)


def test_track_stats_off():
    jtrainer, jstate, ttrainer, tstate = _pair("sgd", track_stats=False)
    assert tstate.metric_states == {} and tstate.loss_states == {}
    train = _batches(4, 3)
    jstate, jhist = jtrainer.fit(
        jstate, lambda: ({k: jnp.asarray(v) for k, v in b.items()}
                         for b in train), verbose=False)
    tstate, thist = ttrainer.fit(tstate, train, verbose=False)
    assert set(thist["epochs"][0]) == set(jhist["epochs"][0]) == {
        "loss", "examples_per_sec"}
    np.testing.assert_allclose(thist["epochs"][0]["loss"],
                               jhist["epochs"][0]["loss"], rtol=1e-5)
    val = _batches(5, 2)
    want = jtrainer.evaluate(
        jstate, [{k: jnp.asarray(v) for k, v in b.items()} for b in val])
    got = ttrainer.evaluate(tstate, val)
    assert set(got) == set(want) == {"total_loss"}
    np.testing.assert_allclose(got["total_loss"], want["total_loss"],
                               rtol=1e-5)


def test_fused_batch_metrics_stay_frozen():
    """With `fused=True` the logits never exist: the batch metrics keep
    their initial states (0 of 0) while the loss still streams."""
    jtrainer, jstate, ttrainer, tstate = _pair("sgd", fused=True)
    batch = _batches(6, 1)[0]
    jstate, jl = jtrainer.train_step(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tl = ttrainer.train_step(tstate, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = jtrainer.metric_results(jstate)
    got = ttrainer.metric_results(tstate)
    for name in ("batch_top_1_categorical_accuracy",
                 "batch_top_10_categorical_accuracy"):
        assert got[name] == want[name] == 0.0
        assert float(tstate.metric_states[name]["count"]) == 0.0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


def _corpus_batch():
    return {"movie_id": np.arange(ITEMS, dtype=np.int32)}


def test_make_corpus_eval_step_matches_the_loop_and_jax(trained):
    _, jtrainer, jstate, ttrainer, _, _ = trained
    model = ttrainer.model
    with torch.no_grad():
        corpus = model.candidate_embeddings(
            {"movie_id": torch.from_numpy(_corpus_batch()["movie_id"])})
    metric = ftk_metric.FactorizedTopK(
        factorized_top_k.BruteForce(device="cpu").index(corpus),
        ks=(1, 5, 10))
    step = models.make_corpus_eval_step(model, metric)
    by_step, by_loop = metric.init(), metric.init()
    batches = _batches(7, 3)
    for batch in batches:
        by_step = step(by_step, batch, corpus)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.no_grad():
            by_loop = metric.update(
                by_loop, model.query_embeddings(tb),
                corpus[tb["movie_id"].long()],
                true_candidate_ids=tb["movie_id"])
    for k in by_step:
        for leaf in ("total", "count"):
            assert torch.equal(by_step[k][leaf], by_loop[k][leaf])
    jmodel = jtrainer.model
    jcorpus = jmodel.apply({"params": jstate.params},
                           {"movie_id": jnp.asarray(
                               _corpus_batch()["movie_id"])},
                           method="candidate_embeddings")
    jmetric = jax_ftk_metric.FactorizedTopK(
        jax_ftk.BruteForce().index(jcorpus), ks=(1, 5, 10))
    jstep = jax_models.retrieval.make_corpus_eval_step(jmodel, jmetric)
    jm = jmetric.init()
    for batch in batches:
        jm = jstep(jstate.params, jm,
                   {k: jnp.asarray(v) for k, v in batch.items()}, jcorpus)
    want = jmetric.result(jm)
    got = metric.result(by_step)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("exclusions", [False, True])
def test_evaluate_with_corpus_metrics_matches_jax(trained, exclusions):
    _, jtrainer, jstate, ttrainer, tstate, _ = trained
    batches = _batches(8, 3, exclusions=exclusions)
    key = "seen" if exclusions else None
    want = jax_models.retrieval.evaluate_with_corpus_metrics(
        jtrainer, jstate,
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
        {"movie_id": jnp.asarray(_corpus_batch()["movie_id"])},
        ks=(1, 5, 10, 50), exclusions_key=key)
    got = models.evaluate_with_corpus_metrics(
        ttrainer, tstate, lambda: iter(batches), _corpus_batch(),
        ks=(1, 5, 10, 50), exclusions_key=key)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-6,
                                   err_msg=name)
    # A Streaming index (exact) gives the BruteForce numbers.
    streamed = models.evaluate_with_corpus_metrics(
        ttrainer, tstate, batches, _corpus_batch(), ks=(1, 5, 10, 50),
        index_factory=lambda: factorized_top_k.Streaming(
            k=50, chunk_size=128, device="cpu"), exclusions_key=key)
    assert streamed == got


def test_trainer_contract_errors_and_optimizer_forms():
    model = _port_model()
    # The meshed Trainer is ported; it takes a `parallel.Mesh`.
    with pytest.raises(TypeError, match="meshed"):
        models.Trainer(model, lambda p: torch.optim.SGD(p, lr=0.1),
                       mesh=object())
    trainer = models.Trainer(model, lambda p: torch.optim.SGD(p, lr=0.1))
    with pytest.raises(ValueError, match="init"):
        trainer.train_step(None, _batches(9, 1)[0])
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    trainer = models.Trainer(model, opt)
    state = trainer.init(sample_batch=_batches(9, 1)[0])
    assert state.opt_state is opt
    state, loss = trainer.train_step(state, _batches(9, 1)[0])
    assert state.step == 1 and torch.isfinite(loss)


def test_prefetched_yields_every_batch_in_order_on_the_device():
    _, _, ttrainer, _ = _pair("sgd")
    batches = _batches(10, 4)
    got = list(ttrainer._prefetched_steps(lambda: iter(batches)))
    assert len(got) == 4
    for want, (batch, sharded, rows) in zip(batches, got):
        assert not sharded and rows == len(want["user_id"])
        for k in want:
            assert isinstance(batch[k], torch.Tensor)
            assert batch[k].device == ttrainer.device
            np.testing.assert_array_equal(batch[k].numpy(), want[k])
    assert list(ttrainer._prefetched_steps([])) == []
