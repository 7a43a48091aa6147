"""Prebuilt DLRM/DCN ranking model.

Port of `examples/prebuilt_dlrm.py` (the counterpart of the reference's
`tfrs.experimental.models.Ranking` usage): declare feature/table configs,
pick an interaction, train on a synthetic CTR task, report AUC, with the
big user table in the sharded partition and the small item table
replicated (`PartialEmbedding` routing by `size_threshold`).

    python -m recommenders_tpu_torch.examples.prebuilt_dlrm [--device cpu]
"""

import numpy as np
import torch

from recommenders_tpu_torch import data, models, optimizers
from recommenders_tpu_torch.embedding import config as cfg
from recommenders_tpu_torch.examples import adagrad, parse_args
from recommenders_tpu_torch.models import ranking as ranking_model
from recommenders_tpu_torch.utils import device as device_lib


def synthetic_ctr(n=50_000, num_dense=8, seed=0):
    rng = np.random.RandomState(seed)
    dense = rng.normal(size=(n, num_dense)).astype(np.float32)
    user = rng.randint(0, 50_000, n).astype(np.int32)
    item = rng.randint(0, 2_000, n).astype(np.int32)
    logit = 1.5 * dense[:, 0] + ((item % 2) - 0.5)
    clicked = (
        rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logit))
    ).astype(np.float32)
    return {
        "dense_features": dense,
        "user_id": user,
        "item_id": item,
        "clicked": clicked,
    }


def make_optimizer(kind: str, model):
    """`adagrad`, or the reference's production split: ClippyAdagrad on
    the embedding tables + Adam on the dense stacks (CompositeOptimizer +
    ClippyAdagrad, experimental/optimizers/*), routed by
    `embedding_param_labels` (`optax.multi_transform` in the JAX
    example)."""
    if kind == "adagrad":
        return adagrad(0.05)
    labels = ranking_model.embedding_param_labels(model)
    return optimizers.composite_optimizer(
        [(lambda p: optimizers.ClippyAdagrad(p, lr=0.05),
          lambda path: labels[".".join(path)] == "embedding"),
         (lambda p: torch.optim.Adam(p, lr=1e-3), lambda path: True)],
        model.named_parameters())


def build_model(interaction: str, device, generator=None) -> models.Ranking:
    user_table = cfg.TableConfig(50_000, 16, name="user")
    item_table = cfg.TableConfig(2_000, 16, name="item")
    feature_configs = (
        cfg.FeatureConfig(table=user_table, name="user_id"),
        cfg.FeatureConfig(table=item_table, name="item_id"),
    )
    if interaction == "dot":
        factory, takes_list = ranking_model.default_interaction, True
    else:
        factory = ranking_model.multi_layer_dcn_interaction()
        takes_list = False
    return models.Ranking(
        feature_configs=feature_configs,
        num_dense_features=8,
        bottom_stack=ranking_model.mlp_stack((64, 16), "relu"),
        feature_interaction=factory,
        interaction_takes_list=takes_list,
        top_stack=ranking_model.mlp_stack((64, 1), "sigmoid"),
        size_threshold=10_000,  # user table sharded, item replicated.
        device=device,
        generator=generator,
    )


def main(epochs: int = 2, interaction: str = "multi_layer_dcn",
         optimizer: str = "adagrad", device="cuda"):
    device = device_lib.resolve(device)
    generator = torch.Generator(device).manual_seed(0)
    model = build_model(interaction, device, generator)
    trainer = models.Trainer(model, make_optimizer(optimizer, model))
    ctr = synthetic_ctr()
    batcher = data.batched(ctr, 4096, shuffle=True)
    state = trainer.init(generator, next(batcher()))
    state, history = trainer.fit(state, batcher, epochs=epochs)
    print(
        f"{optimizer:>14}: final AUC {history['epochs'][-1]['auc']:.4f}"
    )
    return history


if __name__ == "__main__":
    device = parse_args().device
    main(device=device)
    main(optimizer="clippy_composite", device=device)
