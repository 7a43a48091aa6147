"""Featurization: turning raw features into tower inputs.

Port of `examples/featurization.py` (the counterpart of
`docs/examples/featurization.ipynb`): every preprocessing technique the
reference tutorial teaches,

  * string ids -> dense ids        (`StringLookup`  -> data.vocab)
  * id hashing into buckets        (`Hashing`       -> ops.hashing)
  * continuous standardization     (`Normalization` -> preprocessing.Normalizer)
  * timestamp bucketing            (`Discretization`-> preprocessing.Discretizer)
  * title text -> pooled embedding (`TextVectorization` +
                                    `GlobalAveragePooling1D`
                                    -> preprocessing.TextVectorizer + masked_mean)

Adaptation runs on the host (strings); the Normalizer / Discretizer
transforms and the hashing run inside the towers, on the device. The
assembled features feed a two-tower retrieval model end to end.

    python -m recommenders_tpu_torch.examples.featurization [--device cpu]
"""

import numpy as np
import torch
from torch import nn

from recommenders_tpu_torch import data, models
from recommenders_tpu_torch.data import preprocessing as pp
from recommenders_tpu_torch.data import vocab as vocab_lib
from recommenders_tpu_torch.examples import adagrad, dense, embed
from recommenders_tpu_torch.examples import parse_args
from recommenders_tpu_torch.ops import hashing
from recommenders_tpu_torch.utils import device as device_lib

TITLE_WORDS = (
    "star galaxy night return empire dark knight lost city of the "
    "last great secret garden river king queen storm golden shadow "
    "summer winter dream stone fire ice crown legend journey"
).split()


def synthetic_titles(num_movies: int) -> list:
    """Deterministic 2-4 word 'titles', one per movie id."""
    rng = np.random.RandomState(99)
    titles = []
    for _ in range(num_movies):
        n = rng.randint(2, 5)
        words = rng.choice(TITLE_WORDS, size=n, replace=False)
        titles.append(" ".join(words).title() + "!")
    return titles


class QueryTower(nn.Module):
    """User id + device-side normalized / discretized timestamp.
    `flax_names` gives the JAX tower's compact names."""

    flax_names = {"user": "Embed_0", "time": "Embed_1", "out": "Dense_0",
                  "hidden": "Dense_1"}

    def __init__(self, num_users: int, normalizer: pp.Normalizer,
                 discretizer: pp.Discretizer, dim: int = 32, device="cuda",
                 generator=None):
        super().__init__()
        self.normalizer, self.discretizer = normalizer, discretizer
        self.user = embed(num_users, dim, device, generator)
        self.time = embed(discretizer.num_bins, dim // 2, device, generator)
        self.hidden = dense(dim + dim // 2 + 1, 64, device, generator)
        self.out = dense(64, dim, device, generator)
        self.out_features = dim

    def forward(self, inputs):
        ts = inputs["timestamp"]
        x = torch.cat(
            [
                self.user(inputs["user_id"]),
                self.time(self.discretizer(ts)),
                self.normalizer(ts)[..., None],
            ],
            dim=-1,
        )
        return self.out(torch.relu(self.hidden(x)))


class CandidateTower(nn.Module):
    """Hashed movie id + mean-pooled title-token embedding. `flax_names`
    gives the JAX tower's compact names (the token table is built
    first)."""

    flax_names = {"tokens": "Embed_0", "movie": "Embed_1", "out": "Dense_0",
                  "hidden": "Dense_1"}

    def __init__(self, num_hash_bins: int, title_vocab_size: int,
                 dim: int = 32, device="cuda", generator=None):
        super().__init__()
        self.num_hash_bins = num_hash_bins
        self.tokens = embed(title_vocab_size, dim, device, generator)
        self.movie = embed(num_hash_bins, dim, device, generator)
        self.hidden = dense(2 * dim, 64, device, generator)
        self.out = dense(64, dim, device, generator)
        self.out_features = dim

    def forward(self, inputs):
        bucket = hashing.hash_bucket(
            inputs["movie_id"], self.num_hash_bins, salt=7
        )
        tokens = inputs["title_tokens"]
        x = torch.cat(
            [self.movie(bucket), pp.masked_mean(self.tokens(tokens), tokens)],
            dim=-1,
        )
        return self.out(torch.relu(self.hidden(x)))


def adapt(train) -> dict:
    """The host-side adaptation (the Keras `adapt()` step) and the
    assembled tower inputs."""
    user_vocab = vocab_lib.build_vocabulary(
        [f"user_{u}" for u in train.user_ids]
    )
    normalizer = pp.Normalizer.adapt(train.timestamps)
    discretizer = pp.Discretizer.adapt(train.timestamps, num_bins=100)
    titles = synthetic_titles(train.num_movies)
    vectorizer = pp.TextVectorizer.adapt(titles, max_tokens=64)
    title_tokens = vectorizer(titles, sequence_length=4)  # [M, 4]
    return {
        "user_vocab": user_vocab,
        "normalizer": normalizer,
        "discretizer": discretizer,
        "vectorizer": vectorizer,
        "inputs": {
            "user_id": user_vocab.encode(
                [f"user_{u}" for u in train.user_ids]
            ),
            "movie_id": train.movie_ids,
            "timestamp": train.timestamps,
            "title_tokens": title_tokens[train.movie_ids],  # [n, 4]
        },
    }


def build_model(prep: dict, device, generator=None
                ) -> models.TwoTowerRetrieval:
    return models.TwoTowerRetrieval(
        query_tower=QueryTower(
            num_users=prep["user_vocab"].size,
            normalizer=prep["normalizer"],
            discretizer=prep["discretizer"],
            device=device, generator=generator,
        ),
        candidate_tower=CandidateTower(
            num_hash_bins=2048,
            title_vocab_size=prep["vectorizer"].vocab_size,
            device=device, generator=generator,
        ),
        query_key=("user_id", "timestamp"),
        candidate_key=("movie_id", "title_tokens"),
        batch_metric_ks=(10, 100),
    )


def main(epochs: int = 3, device="cuda"):
    device = device_lib.resolve(device)
    train, _ = data.synthetic_movielens().split(0.8)
    prep = adapt(train)
    print(
        f"adapted: {prep['user_vocab'].size} users, "
        f"{prep['discretizer'].num_bins} time buckets, "
        f"{prep['vectorizer'].vocab_size} title tokens"
    )
    generator = torch.Generator(device).manual_seed(0)
    model = build_model(prep, device, generator)
    trainer = models.Trainer(model, adagrad(0.3))
    batcher = data.batched(prep["inputs"], 8192, shuffle=True)
    state = trainer.init(generator, next(batcher()))
    state, history = trainer.fit(state, batcher, epochs=epochs)
    final = history["epochs"][-1]
    print(
        "batch top-100 accuracy with featurized towers: "
        f"{final['batch_top_100_categorical_accuracy']:.4f}"
    )
    return history


if __name__ == "__main__":
    main(device=parse_args().device)
