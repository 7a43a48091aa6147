"""`chip_smoke.py` phase 30's featurization towers against the JAX example.

`examples/featurization.py` trains its two towers under Adagrad 0.3, and
its loss grows step after step: the example's own numerics, not the
port's. Here the JAX example's towers and the port's (`chip_smoke.
FeaturizedQuery` / `FeaturizedCandidate`) take the same five batches of
the example's data on the CPU from the same weights (carried from the
flax init). The JAX loss must grow over tenfold within the five steps,
and the port's losses must track JAX's: the first step, before any
update, to rtol 1e-5; the first three to 1e-4, phase 30's limit card
against CPU over its three steps; all five to 1e-3 (two f32
implementations whose rounding the growing loss amplifies step by step).
The printed gaps are what `PERF.md` cites beside the card-vs-CPU gaps of
`chip_smoke.py --featurization-drift`.

The port's own example (`recommenders_tpu_torch/examples/featurization.
py`) takes the flax weights through `utils.convert.load_flax_params` (its
towers name their flax counterparts' compact layers): its first loss and
its query and candidate embeddings to rtol 1e-5, and one Adagrad step's
change within `STEP_GAP` of JAX's (`tests/torch_examples_common.py`).
"""

import importlib.util
from pathlib import Path

import flax.linen as fnn
import jax
import numpy as np
import optax
import pytest
import torch

from recommenders_tpu import data as jax_data
from recommenders_tpu import models as jax_models
from recommenders_tpu.data import preprocessing as jax_pp

import chip_smoke
from recommenders_tpu_torch.examples import featurization as port_example
from recommenders_tpu_torch.utils import convert
from torch_examples_common import STEP_GAP, step_gap, to_torch
from torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]

STEPS = 5


def _example():
    spec = importlib.util.spec_from_file_location(
        "featurization_example", ROOT / "examples" / "featurization.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_run(prep, size, seed, keep=None):
    """The example's model and Adagrad on `prep`'s batches; returns (its
    initial params as NumPy, per-step losses). With a `keep` dict, the
    model, its params after the steps and the per-step losses land
    there too."""
    example = _example()
    train = prep["train"]
    np.testing.assert_array_equal(
        train.movie_ids, jax_data.synthetic_movielens(
            num_interactions=size.interactions, seed=seed
        ).split(0.8)[0].movie_ids)
    normalizer = jax_pp.Normalizer.adapt(train.timestamps)
    discretizer = jax_pp.Discretizer.adapt(train.timestamps,
                                           num_bins=size.bins)
    model = jax_models.TwoTowerRetrieval(
        query_tower=lambda: example.QueryTower(
            num_users=prep["user_vocab"].size, normalizer=normalizer,
            discretizer=discretizer),
        candidate_tower=lambda: example.CandidateTower(
            num_hash_bins=size.hash_bins,
            title_vocab_size=prep["vectorizer"].vocab_size),
        query_key=("user_id", "timestamp"),
        candidate_key=("movie_id", "title_tokens"),
        batch_metric_ks=(10, 100))
    trainer = jax_models.Trainer(model,
                                 optax.adagrad(chip_smoke.FEATURIZATION_LR))
    state = trainer.init(jax.random.PRNGKey(seed), prep["steps"][0])
    params = jax.tree.map(np.array, fnn.meta.unbox(state.params))
    losses = []
    for batch in prep["steps"]:
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    if keep is not None:
        keep.update(model=model, params=jax.tree.map(
            np.array, fnn.meta.unbox(state.params)))
    return params, losses


def _load(port, params):
    """The flax towers' weights into the port's. Flax names `Dense_0` the
    output layer (`nn.Dense(dim)` is built before its argument) and
    `Embed_0` the first table built: the user table in the query tower,
    the title tokens' in the candidate tower."""
    def dense(layer, p):
        layer.weight.copy_(torch.from_numpy(p["kernel"].T.copy()))
        layer.bias.copy_(torch.from_numpy(p["bias"]))

    q, c = port.query_tower, port.candidate_tower
    pq, pc = params["_query"], params["_candidate"]
    with torch.no_grad():
        q.user.weight.copy_(torch.from_numpy(pq["Embed_0"]["embedding"]))
        q.time.weight.copy_(torch.from_numpy(pq["Embed_1"]["embedding"]))
        c.tokens.weight.copy_(torch.from_numpy(pc["Embed_0"]["embedding"]))
        c.movie.weight.copy_(torch.from_numpy(pc["Embed_1"]["embedding"]))
        for tower, p in ((q, pq), (c, pc)):
            dense(tower.mlp.layers[0], p["Dense_1"])
            dense(tower.mlp.layers[1], p["Dense_0"])


@pytest.mark.parametrize("seed", [0, 1])
def test_port_tracks_the_jax_example_as_its_loss_grows(seed, capsys):
    size = chip_smoke.FeaturizationSize(steps=STEPS)
    prep = chip_smoke.featurization_data(size, seed)
    params, jax_losses = _jax_run(prep, size, seed)
    port = chip_smoke.featurization_model(prep, size, torch.device("cpu"),
                                          seed)
    _load(port, params)
    _, losses = chip_smoke.trainer_steps(
        port, lambda p: chip_smoke.quickstart_adagrad(
            p, chip_smoke.FEATURIZATION_LR), prep["steps"])
    gaps = chip_smoke.relative_gaps(losses, jax_losses)
    with capsys.disabled():
        print(f"\nfeaturization seed {seed}: JAX losses a row "
              f"{[round(x / size.batch, 3) for x in jax_losses]}, port vs "
              f"JAX relative gaps {[float(f'{g:.3g}') for g in gaps]}")
    # The example's own loss grows: over tenfold its first within 5 steps.
    assert max(jax_losses) > 10 * jax_losses[0], jax_losses
    assert gaps[0] <= 1e-5, gaps
    assert max(gaps[:3]) <= 1e-4, gaps
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-3)


def test_the_port_example_carries_the_flax_towers():
    size = chip_smoke.FeaturizationSize(steps=1)
    prep = chip_smoke.featurization_data(size, 0)
    kept = {}
    start, jax_losses = _jax_run(prep, size, 0, kept)
    port = port_example.build_model(prep, torch.device("cpu"))
    convert.load_flax_params(port, start)
    batch = prep["steps"][0]
    # As JAX arrays, as the JAX trainer hands them to the towers: the
    # Discretizer takes NumPy input through a float64 path, and the
    # example's 9-digit timestamps can tie a boundary in float32.
    jax_batch = jax.tree.map(jax.numpy.asarray, batch)
    with torch.no_grad():
        for method in ("query_embeddings", "candidate_embeddings"):
            want = kept["model"].apply({"params": start}, jax_batch,
                                       method=method)
            got = getattr(port, method)(to_torch(batch))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
    _, losses = chip_smoke.trainer_steps(
        port, port_example.adagrad(chip_smoke.FEATURIZATION_LR),
        prep["steps"])
    np.testing.assert_allclose(losses[0], jax_losses[0], rtol=1e-5)
    gap = step_gap(start, convert.to_flax_params(port), kept["params"])
    assert gap <= STEP_GAP["adagrad"], gap
