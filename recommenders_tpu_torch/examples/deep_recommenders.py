"""Deeper retrieval models: stacking dense layers on the towers.

Port of `examples/deep_recommenders.py` (the counterpart of
`docs/examples/deep_recommenders.ipynb`): starting from the
embedding-only two-tower retrieval model, add hidden layers to both
towers and compare corpus-level top-k accuracy. The reference reports
top-100 ≈ 0.27 for 1-layer and ≈ 0.29 for 2-layer towers on real
ML-100K (BASELINE.md); on synthetic interactions the absolute numbers
differ but the comparison methodology is the same, and, as the reference
notebook stresses, deeper is NOT automatically better.

    python -m recommenders_tpu_torch.examples.deep_recommenders [--device cpu]
"""

import torch

from recommenders_tpu_torch import data, metrics, models
from recommenders_tpu_torch.examples import adagrad, parse_args
from recommenders_tpu_torch.layers import factorized_top_k
from recommenders_tpu_torch.utils import device as device_lib


def build_model(num_users: int, num_movies: int, mlp_units, device,
                generator=None) -> models.TwoTowerRetrieval:
    return models.TwoTowerRetrieval(
        query_tower=models.EmbeddingTower(
            num_users, 64, mlp_units=mlp_units, device=device,
            generator=generator,
        ),
        candidate_tower=models.EmbeddingTower(
            num_movies, 64, mlp_units=mlp_units, device=device,
            generator=generator,
        ),
        query_key="user_id",
        candidate_key="movie_id",
    )


def train_and_eval(train, test, mlp_units, epochs=3, device="cuda"):
    device = device_lib.resolve(device)
    generator = torch.Generator(device).manual_seed(42)
    model = build_model(train.num_users, train.num_movies, mlp_units, device,
                        generator)
    trainer = models.Trainer(model, adagrad(0.1))
    batcher = data.batched(
        train.as_dict(), 4096, shuffle=True, seed=42
    )
    state = trainer.init(generator, next(iter(batcher())))
    state, _ = trainer.fit(state, batcher, epochs=epochs, verbose=False)

    with torch.no_grad():
        model.eval()
        candidates = model.candidate_embeddings(
            {"movie_id": torch.arange(train.num_movies, device=device)})
        index = factorized_top_k.BruteForce(k=100, device=device).index(
            candidates)
        metric = metrics.FactorizedTopK(candidates=index, ks=(10, 100))
        queries = model.query_embeddings(
            {"user_id": torch.from_numpy(test.user_ids[:4096]).to(device)})
        true = candidates[torch.from_numpy(test.movie_ids[:4096]).to(device)]
        mstate = metric.update(metric.init(), queries, true)
    return {
        name: float(v) for name, v in metric.result(mstate).items()
    }


def main(epochs: int = 3, device="cuda"):
    train, test = data.synthetic_movielens(
        num_interactions=60_000
    ).split(0.8)
    layer_configs = {
        "embedding-only": (),
        "1 hidden layer": (64, 32),
    }
    results = {}
    for name, units in layer_configs.items():
        results[name] = train_and_eval(train, test, units, epochs, device)
        print(
            f"{name:16s} top-10 "
            f"{results[name]['factorized_top_k/top_10_categorical_accuracy']:.4f}"
            f"  top-100 "
            f"{results[name]['factorized_top_k/top_100_categorical_accuracy']:.4f}"
        )
    return results


if __name__ == "__main__":
    main(device=parse_args().device)
