"""Sequential retrieval: GRU user tower over watch histories.

Port of `examples/sequential_retrieval.py` (the counterpart of
`docs/examples/sequential_retrieval.ipynb`): the query is a padded
history of watched movies encoded by a GRU (or self-attention); the
candidate is the next movie watched.

    python -m recommenders_tpu_torch.examples.sequential_retrieval [--device cpu]
"""

import numpy as np
import torch

from recommenders_tpu_torch import data, models
from recommenders_tpu_torch.embedding.config import PAD_ID
from recommenders_tpu_torch.examples import adam, parse_args
from recommenders_tpu_torch.utils import device as device_lib


def sequences_from_interactions(ds, length: int = 10):
    """Per-user chronological histories → (history, next_movie) examples."""
    order = np.lexsort((ds.timestamps, ds.user_ids))
    users, movies = ds.user_ids[order], ds.movie_ids[order]
    histories, labels = [], []
    start = 0
    for end in range(1, len(users) + 1):
        if end == len(users) or users[end] != users[start]:
            watched = movies[start:end]
            for t in range(1, len(watched)):
                hist = watched[max(0, t - length):t]
                row = np.full((length,), PAD_ID, np.int32)
                row[: len(hist)] = hist
                histories.append(row)
                labels.append(watched[t])
            start = end
    return {
        "history": np.stack(histories),
        "next_movie": np.asarray(labels, np.int32),
    }


def build_model(num_movies: int, encoder: str, device,
                generator=None) -> models.TwoTowerRetrieval:
    return models.TwoTowerRetrieval(
        query_tower=models.SequenceTower(
            vocab_size=num_movies, embedding_dim=32, encoder=encoder,
            device=device, generator=generator,
        ),
        candidate_tower=models.EmbeddingTower(num_movies, 32, device=device,
                                              generator=generator),
        query_key="history",
        candidate_key="next_movie",
        batch_metric_ks=(1, 10, 100),
    )


def main(epochs: int = 2, encoder: str = "gru", device="cuda"):
    device = device_lib.resolve(device)
    ds = data.synthetic_movielens(num_interactions=30_000)
    examples = sequences_from_interactions(ds)
    print(f"{len(examples['next_movie'])} sequence examples")

    generator = torch.Generator(device).manual_seed(0)
    model = build_model(ds.num_movies, encoder, device, generator)
    trainer = models.Trainer(model, adam(5e-3))
    batcher = data.batched(examples, 4096, shuffle=True)
    state = trainer.init(generator, next(batcher()))
    state, history = trainer.fit(state, batcher, epochs=epochs)
    final = history["epochs"][-1]
    print(
        f"{encoder} tower: batch top-100 accuracy "
        f"{final['batch_top_100_categorical_accuracy']:.4f}"
    )
    return history


if __name__ == "__main__":
    main(device=parse_args().device)
