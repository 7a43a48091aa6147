"""The port's serving example and the quickstart slice against the JAX
examples, the runner, and no fallback from the card, on the CPU.

  - efficient_serving at 2,000 rows in both packages (the JAX example run
    as it is, its printed recalls read with `capsys`; on the CPU its
    Bucketed index runs the package's plain reference, as its tests
    do): BruteForce ids equal (the JAX ids from its own index over the
    example's corpus and queries), Bucketed recall equal to the printed
    three digits, ScaNN recall within 0.02 (two k-means builds);
  - the quickstart slice: one epoch of the example's model and Adagrad
    0.5 from the JAX trainer's init (carried with `utils.convert`) over
    the same `data.batched` order in both packages, then the example's
    corpus metrics: top-10/50/100 within 0.003 of JAX's, the bound of
    `tools/quality_parity.py`;
  - the runner (`python -m recommenders_tpu_torch.tools.run_examples
    --device cpu quickstart`) exits 0; without CUDA every example's
    `main()` and the runner's default device raise.
"""

import importlib
import importlib.util
import re
from pathlib import Path

import flax.linen as fnn
import jax
import numpy as np
import optax
import pytest
import torch

from recommenders_tpu import data as jax_data
from recommenders_tpu import metrics as jax_metrics
from recommenders_tpu import models as jax_models
from recommenders_tpu.layers import factorized_top_k as jax_ftk
from recommenders_tpu_torch import data, models
from recommenders_tpu_torch.examples import adagrad
from recommenders_tpu_torch.examples import efficient_serving
from recommenders_tpu_torch.examples import quickstart
from recommenders_tpu_torch.tools import run_examples
from recommenders_tpu_torch.utils import convert
from torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
EXAMPLES = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
SLICE_MARGIN = 0.003


def jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_efficient_serving_against_the_jax_example(capsys):
    example = jax_example("efficient_serving")
    rows = 2_000
    example.main(corpus_size=rows)
    printed = capsys.readouterr().out
    recalls = dict(re.findall(r"^(\w+)[^\n]*recall=([0-9.]+)", printed,
                              re.M))
    rng = np.random.RandomState(0)
    corpus = example.clustered_corpus(rng, rows, 128)
    queries = rng.normal(size=(256, 128)).astype(np.float32)
    _, jax_ids = jax_ftk.BruteForce(k=10).index(corpus)(queries)

    got = efficient_serving.main(corpus_size=rows, device="cpu")
    np.testing.assert_array_equal(got["brute_force_ids"],
                                  np.asarray(jax_ids))
    assert f"{got['bucketed_recall']:.3f}" == recalls["Bucketed"], printed
    assert abs(got["scann_recall"] - float(recalls["ScaNN"])) <= 0.02, (
        got["scann_recall"], printed)


def _jax_quickstart_epoch(train, test, batches):
    """The JAX example's model, Adagrad 0.5 and corpus metrics over one
    epoch of `batches`; returns (its initial params, its metrics)."""
    model = jax_models.TwoTowerRetrieval(
        query_tower=lambda: jax_models.EmbeddingTower(train.num_users, 64),
        candidate_tower=lambda: jax_models.EmbeddingTower(
            train.num_movies, 64),
        query_key="user_id",
        candidate_key="movie_id",
    )
    trainer = jax_models.Trainer(model, optax.adagrad(quickstart.LEARNING_RATE))
    state = trainer.init(jax.random.PRNGKey(quickstart.SEED),
                         next(iter(batches())))
    start = jax.tree.map(np.array, fnn.meta.unbox(state.params))
    state, _ = trainer.fit(state, batches, epochs=1, verbose=False)
    candidates = model.apply(
        {"params": state.params},
        {"movie_id": np.arange(train.num_movies, dtype=np.int32)},
        method="candidate_embeddings")
    index = jax_ftk.BruteForce(k=100).index(candidates)
    metric = jax_metrics.FactorizedTopK(candidates=index, ks=quickstart.KS)
    queries = model.apply({"params": state.params},
                          {"user_id": test.user_ids[:4096]},
                          method="query_embeddings")
    mstate = metric.update(metric.init(), queries,
                           candidates[test.movie_ids[:4096]])
    return start, {k: float(v) for k, v in metric.result(mstate).items()}


def test_quickstart_slice_tracks_the_jax_example():
    train, test = data.synthetic_movielens().split(0.8)
    jax_train, jax_test = jax_data.synthetic_movielens().split(0.8)
    np.testing.assert_array_equal(train.movie_ids, jax_train.movie_ids)
    start, want = _jax_quickstart_epoch(
        jax_train, jax_test, jax_data.batched(
            jax_train.as_dict(), 4096, shuffle=True, seed=quickstart.SEED))

    model = quickstart.build_model(train.num_users, train.num_movies, CPU)
    convert.load_flax_params(model, start)
    trainer = models.Trainer(model, adagrad(quickstart.LEARNING_RATE))
    batches = data.batched(train.as_dict(), 4096, shuffle=True,
                           seed=quickstart.SEED)
    state = trainer.init(torch.Generator().manual_seed(quickstart.SEED),
                         next(iter(batches())))
    trainer.fit(state, batches, epochs=1, verbose=False)
    got, _, _ = quickstart.corpus_metrics(model, train, test, CPU)
    assert got.keys() == want.keys()
    for name in want:
        assert abs(got[name] - want[name]) <= SLICE_MARGIN, (name, got, want)


def test_every_jax_example_has_a_port():
    port = run_examples.example_names()
    assert port == EXAMPLES


def test_the_runner_runs_an_example_on_the_cpu(capsys):
    assert run_examples.main(["--device", "cpu", "quickstart"]) == 0
    out = capsys.readouterr().out
    assert "[PASS] quickstart.py" in out and "1/1 examples passed" in out


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal; a card is present")
@pytest.mark.parametrize("name", EXAMPLES)
def test_no_fallback_without_a_card(name):
    module = importlib.import_module(
        f"recommenders_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal; a card is present")
def test_the_runner_refuses_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_examples.main(["quickstart"])
