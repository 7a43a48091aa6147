"""Multitask: joint retrieval + rating with shared towers.

Port of `examples/multitask.py` (the counterpart of
`docs/examples/multitask.ipynb`): sweep loss weights across
rating-only, retrieval-only, and joint configurations (the tutorial's
reported target is rating RMSE ≈ 1.11 on real MovieLens).

    python -m recommenders_tpu_torch.examples.multitask [--device cpu]
"""

import torch

from recommenders_tpu_torch import data, models
from recommenders_tpu_torch.examples import adagrad, parse_args
from recommenders_tpu_torch.utils import device as device_lib


def build_model(num_users: int, num_movies: int, retrieval_weight: float,
                rating_weight: float, device,
                generator=None) -> models.Multitask:
    return models.Multitask(
        query_tower=models.EmbeddingTower(num_users, 32, device=device,
                                          generator=generator),
        candidate_tower=models.EmbeddingTower(num_movies, 32, device=device,
                                              generator=generator),
        retrieval_weight=retrieval_weight,
        rating_weight=rating_weight,
        generator=generator,
    )


def run(retrieval_weight: float, rating_weight: float, epochs: int = 2,
        device="cuda"):
    device = device_lib.resolve(device)
    train, test = data.synthetic_movielens(num_interactions=30_000).split(0.8)
    train_d = dict(train.as_dict())
    train_d["user_rating"] = train_d.pop("rating")
    test_d = dict(test.as_dict())
    test_d["user_rating"] = test_d.pop("rating")

    generator = torch.Generator(device).manual_seed(0)
    model = build_model(train.num_users, train.num_movies, retrieval_weight,
                        rating_weight, device, generator)
    trainer = models.Trainer(model, adagrad(0.2))
    batcher = data.batched(train_d, 4096, shuffle=True)
    state = trainer.init(generator, next(batcher()))
    state, _ = trainer.fit(state, batcher, epochs=epochs, verbose=False)
    results = trainer.evaluate(state, data.batched(test_d, 8192))
    print(
        f"retrieval_w={retrieval_weight} rating_w={rating_weight}: "
        f"RMSE={results['rating_rmse']:.4f} "
        f"batch_top10={results['batch_top_10_categorical_accuracy']:.4f}"
    )
    return results


def main(epochs: int = 2, device="cuda"):
    return {
        "rating": run(0.0, 1.0, epochs, device),     # Rating-specialized.
        "retrieval": run(1.0, 0.0, epochs, device),  # Retrieval-specialized.
        "joint": run(1.0, 1.0, epochs, device),      # Joint.
    }


if __name__ == "__main__":
    main(device=parse_args().device)
