"""The port's ranking examples' own models against the JAX examples', on
the CPU: basic_ranking's `RankingModel`, deep_ranking_dcn's `DCNModel`
(full and low rank), listwise_ranking's `ListScoringModel` (MSE and
ListMLE), unified_embedding's `UnifiedCTR` (unified and collisionless),
prebuilt_dlrm's `Ranking` (dot + Adagrad, DCN + Clippy Adagrad / Adam)
and hybrid_dlrm's `DLRMHead`.

Each JAX example (`examples/<name>.py`, loaded by path and left as it
is) builds its flax model under its own optimizer; the port's example
builds its counterpart with `build_model`, and `utils.convert.
load_flax_params` carries the flax init across. On one batch drawn with
NumPy from a seed: the loss to rtol 1e-5 and the predictions to rtol
1e-5 (atol 1e-6: values near zero, matmuls summed in another order),
then one step of each example's optimizer within `STEP_GAP`
(`tests/torch_examples_common.py`).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from recommenders_tpu import data as jax_data
from recommenders_tpu.models import ranking as jax_ranking
from recommenders_tpu import models as jax_models
from recommenders_tpu_torch.examples import basic_ranking
from recommenders_tpu_torch.examples import deep_ranking_dcn
from recommenders_tpu_torch.examples import hybrid_dlrm
from recommenders_tpu_torch.examples import listwise_ranking
from recommenders_tpu_torch.examples import prebuilt_dlrm
from recommenders_tpu_torch.examples import unified_embedding
from recommenders_tpu_torch.utils import convert
from torch_examples_common import (B, CPU, STEP_GAP, jax_example,
                                   movielens_batch, numpy_params,
                                   ranking_outputs, step_gap, to_torch,
                                   trainer_parity)
from torch_threads import torch_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("example", ["basic_ranking", "deep_ranking_dcn",
                                     "deep_ranking_dcn_low_rank"])
def test_rating_models(example):
    batch, ds = movielens_batch()
    projection = 16 if example.endswith("low_rank") else None
    if projection is None and example == "basic_ranking":
        jax_model = jax_example(example).RankingModel(
            num_users=ds.num_users, num_movies=ds.num_movies)
        port_model = basic_ranking.build_model(ds.num_users, ds.num_movies,
                                               CPU)
    else:
        jax_model = jax_example("deep_ranking_dcn").DCNModel(
            num_users=ds.num_users, num_movies=ds.num_movies,
            projection_dim=projection or 0)
        port_model = deep_ranking_dcn.build_model(
            ds.num_users, ds.num_movies, projection or 0, CPU)
    trainer_parity(jax_model, port_model, batch, optax.adam(1e-3),
                   lambda p: torch.optim.Adam(p, lr=1e-3), "adam",
                   ranking_outputs(jax_model, port_model, batch))


@pytest.mark.parametrize("loss_kind", ["mse", "list_mle"])
def test_listwise_model(loss_kind):
    ds = jax_data.synthetic_movielens(num_interactions=20_000)
    lists = jax_data.sample_listwise(
        ds.user_ids, ds.movie_ids, ds.ratings, num_list_per_user=3,
        num_examples_per_list=8)
    batch = {k: v[:B] for k, v in lists.items()}
    jax_model = jax_example("listwise_ranking").ListScoringModel(
        num_users=ds.num_users, num_movies=ds.num_movies,
        loss_kind=loss_kind)
    port_model = listwise_ranking.build_model(ds.num_users, ds.num_movies,
                                              loss_kind, CPU)
    # ListMLE is invariant to a shift of a list's scores: the last
    # Dense's bias moves it, so its gradient is zero up to rounding.
    trainer_parity(jax_model, port_model, batch, optax.adam(1e-2),
                   lambda p: torch.optim.Adam(p, lr=1e-2), "adam",
                   ranking_outputs(jax_model, port_model, batch),
                   invariant=(("score_mlp", "layers_2", "bias")
                              if loss_kind == "list_mle" else None))


@pytest.mark.parametrize("use_unified", [True, False])
def test_unified_ctr(use_unified):
    ctr = jax_example("unified_embedding").synthetic_ctr(n=4 * B)
    batch = {k: v[:B] for k, v in ctr.items()}
    jax_model = jax_example("unified_embedding").UnifiedCTR(
        use_unified=use_unified)
    port_model = unified_embedding.build_model(use_unified, CPU)
    trainer_parity(jax_model, port_model, batch, optax.adagrad(0.1),
                   lambda p: torch.optim.Adagrad(
                       p, lr=0.1, initial_accumulator_value=0.1, eps=0.0),
                   "adagrad", ranking_outputs(jax_model, port_model, batch))


@pytest.mark.parametrize("interaction,optimizer",
                         [("dot", "adagrad"),
                          ("multi_layer_dcn", "clippy_composite")])
def test_prebuilt_dlrm(interaction, optimizer):
    example = jax_example("prebuilt_dlrm")
    ctr = example.synthetic_ctr(n=B)
    np.testing.assert_array_equal(ctr["clicked"], prebuilt_dlrm.synthetic_ctr(
        n=B)["clicked"])
    jax_cfg = example.cfg
    configs = (
        jax_cfg.FeatureConfig(table=jax_cfg.TableConfig(50_000, 16,
                                                        name="user"),
                              name="user_id"),
        jax_cfg.FeatureConfig(table=jax_cfg.TableConfig(2_000, 16,
                                                        name="item"),
                              name="item_id"),
    )
    dot = interaction == "dot"
    jax_model = jax_models.Ranking(
        feature_configs=configs,
        bottom_stack=lambda: example.blocks.MLP(
            units=(64, 16), final_activation="relu"),
        feature_interaction=(jax_ranking.default_interaction if dot else
                             jax_ranking.multi_layer_dcn_interaction()),
        interaction_takes_list=dot,
        top_stack=lambda: example.blocks.MLP(
            units=(64, 1), final_activation="sigmoid"),
        size_threshold=10_000,
    )
    port_model = prebuilt_dlrm.build_model(interaction, CPU)
    trainer_parity(jax_model, port_model, ctr,
                   example.make_optimizer(optimizer),
                   prebuilt_dlrm.make_optimizer(optimizer, port_model),
                   "adagrad" if optimizer == "adagrad" else "adam",
                   ranking_outputs(jax_model, port_model, ctr))


def test_hybrid_dlrm_head():
    """The head alone on the engine's activations: its loss and
    predictions, and one `optax.adam(1e-2)` step against torch's Adam."""
    example = jax_example("hybrid_dlrm")
    batch = next(example.make_batches(np.random.RandomState(0), 1, B))
    rng = np.random.RandomState(1)
    acts = {k: (0.25 * rng.normal(size=(B, 16))).astype(np.float32)
            for k in ("user_id", "item_id")}
    head = example.DLRMHead()
    params = numpy_params(head.init(jax.random.PRNGKey(0), batch,
                                    acts)["params"])
    port = hybrid_dlrm.DLRMHead(device=CPU)
    convert.load_flax_params(port, params)
    jax_loss, jax_pred = head.apply({"params": params}, batch, acts)
    loss, pred = port(to_torch(batch), to_torch(acts))
    np.testing.assert_allclose(float(loss), float(jax_loss), rtol=1e-5)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jax_pred),
                               rtol=1e-5, atol=1e-6)

    grads = jax.grad(lambda p: head.apply({"params": p}, batch, acts)[0])(
        params)
    opt = optax.adam(1e-2)
    updates, _ = opt.update(grads, opt.init(params), params)
    want = numpy_params(optax.apply_updates(params, updates))
    optimizer = hybrid_dlrm.adam(hybrid_dlrm.HEAD_LEARNING_RATE)(
        port.parameters())
    optimizer.zero_grad()
    port(to_torch(batch), to_torch(acts))[0].backward()
    optimizer.step()
    gap = step_gap(params, convert.to_flax_params(port), want)
    assert gap <= STEP_GAP["adam"], gap

