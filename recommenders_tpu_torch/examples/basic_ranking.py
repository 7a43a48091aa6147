"""Basic ranking: predict ratings with an MSE tower model.

Port of `examples/basic_ranking.py` (the counterpart of
`docs/examples/basic_ranking.ipynb`): embed (user, movie), concatenate,
run an MLP to a rating prediction, train with MSE, report RMSE.

    python -m recommenders_tpu_torch.examples.basic_ranking [--device cpu]
"""

import torch

from recommenders_tpu_torch import data, metrics, models, tasks
from recommenders_tpu_torch.examples import adam, embed, parse_args
from recommenders_tpu_torch.examples import sequential
from recommenders_tpu_torch.utils import device as device_lib


class RankingModel(models.Model):
    """User and movie embeddings of width 32, concatenated, through
    Dense(256) relu Dense(64) relu Dense(1); MSE against the rating."""

    flax_names = {"user_emb": "user_emb", "movie_emb": "movie_emb",
                  "mlp": "mlp"}

    def __init__(self, num_users: int, num_movies: int, device="cuda",
                 generator=None):
        super().__init__()
        self.user_emb = embed(num_users, 32, device, generator)
        self.movie_emb = embed(num_movies, 32, device, generator)
        self.mlp = sequential(64, (256, 64, 1), device, generator)
        self.task = tasks.Ranking(loss_fn=tasks.mean_squared_error)

    def compute_loss(self, batch, training=False, generator=None):
        x = torch.cat(
            [
                self.user_emb(batch["user_id"]),
                self.movie_emb(batch["movie_id"]),
            ],
            dim=-1,
        )
        pred = self.mlp(x)[:, 0]
        out = self.task(batch["rating"], pred)
        return out.loss, {"labels": out.labels, "predictions": out.predictions}

    def metrics(self):
        return {"rmse": metrics.RootMeanSquaredError()}

    def update_metrics(self, states, batch, aux):
        return {
            "rmse": metrics.RootMeanSquaredError().update(
                states["rmse"], aux["labels"], aux["predictions"]
            )
        }


def build_model(num_users: int, num_movies: int, device,
                generator=None) -> RankingModel:
    return RankingModel(num_users, num_movies, device, generator)


def main(epochs: int = 3, device="cuda"):
    device = device_lib.resolve(device)
    train, test = data.synthetic_movielens().split(0.8)
    generator = torch.Generator(device).manual_seed(0)
    model = build_model(train.num_users, train.num_movies, device, generator)
    trainer = models.Trainer(model, adam(1e-3))
    batcher = data.batched(train.as_dict(), 8192, shuffle=True)
    state = trainer.init(generator, next(batcher()))
    state, _ = trainer.fit(state, batcher, epochs=epochs)
    results = trainer.evaluate(state, data.batched(test.as_dict(), 8192))
    print(f"test RMSE: {results['rmse']:.4f}")
    return results


if __name__ == "__main__":
    main(device=parse_args().device)
