"""Quickstart: two-tower retrieval on synthetic MovieLens.

Port of `examples/quickstart.py` (the reference's README quickstart /
`docs/examples/quickstart.ipynb`): build user and movie towers, train
with in-batch sampled softmax, index the corpus, retrieve top-k for a
user.

    python -m recommenders_tpu_torch.examples.quickstart [--device cpu]
"""

import numpy as np
import torch

from recommenders_tpu_torch import data, metrics, models
from recommenders_tpu_torch.examples import adagrad, parse_args
from recommenders_tpu_torch.layers import factorized_top_k
from recommenders_tpu_torch.utils import device as device_lib

SEED = 42
LEARNING_RATE = 0.5
KS = (10, 50, 100)


def build_model(num_users: int, num_movies: int, device,
                generator=None) -> models.TwoTowerRetrieval:
    return models.TwoTowerRetrieval(
        query_tower=models.EmbeddingTower(num_users, 64, device=device,
                                          generator=generator),
        candidate_tower=models.EmbeddingTower(num_movies, 64, device=device,
                                              generator=generator),
        query_key="user_id",
        candidate_key="movie_id",
    )


@torch.no_grad()
def corpus_metrics(model, train, test, device) -> dict:
    """Top-k accuracy of the first 4,096 test queries over a brute-force
    index of every movie; returns the index's inputs too."""
    model.eval()
    movie_ids = torch.arange(train.num_movies, device=device)
    candidates = model.candidate_embeddings({"movie_id": movie_ids})
    index = factorized_top_k.BruteForce(k=100, device=device).index(
        candidates)
    metric = metrics.FactorizedTopK(candidates=index, ks=KS)
    queries = model.query_embeddings(
        {"user_id": torch.from_numpy(test.user_ids[:4096]).to(device)})
    true = candidates[torch.from_numpy(test.movie_ids[:4096]).to(device)]
    mstate = metric.update(metric.init(), queries, true)
    results = {name: float(value)
               for name, value in metric.result(mstate).items()}
    return results, candidates, queries


def main(epochs: int = 2, batch_size: int = 4096, device="cuda"):
    device = device_lib.resolve(device)
    train, test = data.synthetic_movielens().split(0.8)

    generator = torch.Generator(device).manual_seed(SEED)
    model = build_model(train.num_users, train.num_movies, device,
                        generator)
    trainer = models.Trainer(model, adagrad(LEARNING_RATE))

    batcher = data.batched_native_or_python(
        train.as_dict(), batch_size, shuffle=True, seed=SEED
    )
    state = trainer.init(generator, next(iter(batcher())))
    state, history = trainer.fit(state, batcher, epochs=epochs)

    # Corpus-level evaluation with a brute-force index over all movies.
    results, candidates, queries = corpus_metrics(model, train, test, device)
    for name, value in results.items():
        print(f"{name}: {value:.4f}")

    # Serve: top-3 movies for one user, with STRING identifiers, decoded
    # on the host (see layers.factorized_top_k.TopK).
    titles = np.asarray(
        [f"Movie #{i}" for i in range(train.num_movies)]
    )
    named = factorized_top_k.BruteForce(k=100, device=device).index(
        candidates, titles)
    scores, names = named(queries[:1], k=3)
    print("user 0 recommendations:", names[0].tolist())
    return state


if __name__ == "__main__":
    main(device=parse_args().device)
