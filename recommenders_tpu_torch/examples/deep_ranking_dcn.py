"""DCN ranking: feature crosses for rating prediction.

Port of `examples/deep_ranking_dcn.py` (the counterpart of
`docs/examples/dcn.ipynb`): embed sparse features, apply a DCN-v2 cross
layer (optionally low-rank) over the concatenated vector, then a deep
stack.

    python -m recommenders_tpu_torch.examples.deep_ranking_dcn [--device cpu]
"""

import torch

from recommenders_tpu_torch import data, metrics, models, tasks
from recommenders_tpu_torch.examples import adam, embed, parse_args
from recommenders_tpu_torch.examples import sequential
from recommenders_tpu_torch.layers.feature_interaction import dcn
from recommenders_tpu_torch.utils import device as device_lib


class DCNModel(models.Model):
    """User and movie embeddings of width 32, a DCN-v2 cross over their
    concatenation (full rank, or `projection_dim` low rank), then
    Dense(128) relu Dense(64) relu Dense(1); MSE against the rating."""

    flax_names = {"user_emb": "user_emb", "movie_emb": "movie_emb",
                  "cross": "cross", "deep": "deep"}

    def __init__(self, num_users: int, num_movies: int,
                 projection_dim: int = 0, device="cuda", generator=None):
        super().__init__()
        self.user_emb = embed(num_users, 32, device, generator)
        self.movie_emb = embed(num_movies, 32, device, generator)
        self.cross = dcn.Cross(64, projection_dim=projection_dim or None,
                               device=device, generator=generator)
        self.deep = sequential(64, (128, 64, 1), device, generator)
        self.task = tasks.Ranking(loss_fn=tasks.mean_squared_error)

    def compute_loss(self, batch, training=False, generator=None):
        x = torch.cat(
            [
                self.user_emb(batch["user_id"]),
                self.movie_emb(batch["movie_id"]),
            ],
            dim=-1,
        )
        x = self.cross(x)
        pred = self.deep(x)[:, 0]
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


def build_model(num_users: int, num_movies: int, projection_dim: int,
                device, generator=None) -> DCNModel:
    return DCNModel(num_users, num_movies, projection_dim, device, generator)


def main(epochs: int = 3, projection_dim: int = 0, device="cuda"):
    device = device_lib.resolve(device)
    train, test = data.synthetic_movielens().split(0.8)
    generator = torch.Generator(device).manual_seed(0)
    model = build_model(train.num_users, train.num_movies, projection_dim,
                        device, generator)
    trainer = models.Trainer(model, adam(1e-3))
    batcher = data.batched(train.as_dict(), 8192, shuffle=True)
    state = trainer.init(generator, next(batcher()))
    state, _ = trainer.fit(state, batcher, epochs=epochs)
    results = trainer.evaluate(state, data.batched(test.as_dict(), 8192))
    kind = "low-rank" if projection_dim else "full-rank"
    print(f"{kind} DCN test RMSE: {results['rmse']:.4f}")
    return results


if __name__ == "__main__":
    device = parse_args().device
    main(device=device)
    main(projection_dim=16, device=device)
