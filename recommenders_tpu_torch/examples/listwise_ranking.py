"""Listwise ranking: optimize NDCG over sampled lists.

Port of `examples/listwise_ranking.py` (the counterpart of
`docs/examples/listwise_ranking.ipynb`, which uses tensorflow-ranking
losses): sample per-user movie lists, score them with a tower model,
train with pointwise MSE against the listwise losses, compare NDCG.

    python -m recommenders_tpu_torch.examples.listwise_ranking [--device cpu]
"""

import torch

from recommenders_tpu_torch import data, metrics, models, tasks
from recommenders_tpu_torch.examples import adam, embed, parse_args
from recommenders_tpu_torch.examples import sequential
from recommenders_tpu_torch.tasks import listwise
from recommenders_tpu_torch.utils import device as device_lib

LOSSES = {
    "mse": tasks.mean_squared_error,
    "list_mle": listwise.list_mle,
    "pairwise": listwise.pairwise_logistic,
    "lambdarank": listwise.lambdarank,
    "approx_ndcg": listwise.approx_ndcg,
}


class ListScoringModel(models.Model):
    """Scores each `[B, L]` list entry from the user's and the movie's
    embeddings (width 32) through Dense(64) relu Dense(1)."""

    flax_names = {"user_emb": "user_emb", "movie_emb": "movie_emb",
                  "score_mlp": "score_mlp"}

    def __init__(self, num_users: int, num_movies: int,
                 loss_kind: str = "list_mle", device="cuda", generator=None):
        super().__init__()
        self.user_emb = embed(num_users, 32, device, generator)
        self.movie_emb = embed(num_movies, 32, device, generator)
        self.score_mlp = sequential(64, (64, 1), device, generator)
        self.task = tasks.Ranking(loss_fn=LOSSES[loss_kind])

    def compute_loss(self, batch, training=False, generator=None):
        u = self.user_emb(batch["user_id"])[:, None, :]
        m = self.movie_emb(batch["movie_id"])
        x = torch.cat([u.expand(m.shape), m], dim=-1)
        scores = self.score_mlp(x)[..., 0]
        out = self.task(batch["rating"], scores)
        return out.loss, {"labels": out.labels, "predictions": out.predictions}

    def metrics(self):
        return {"ndcg": metrics.NDCG(), "ndcg@5": metrics.NDCG(k=5)}

    def update_metrics(self, states, batch, aux):
        return {
            name: m.update(states[name], aux["labels"], aux["predictions"])
            for name, m in self.metrics().items()
        }


def build_model(num_users: int, num_movies: int, loss_kind: str, device,
                generator=None) -> ListScoringModel:
    return ListScoringModel(num_users, num_movies, loss_kind, device,
                            generator)


def run(loss_kind: str, epochs: int = 2, device="cuda"):
    device = device_lib.resolve(device)
    ds = data.synthetic_movielens(num_interactions=20_000)
    lists = data.sample_listwise(
        ds.user_ids, ds.movie_ids, ds.ratings,
        num_list_per_user=3, num_examples_per_list=8,
    )
    generator = torch.Generator(device).manual_seed(0)
    model = build_model(ds.num_users, ds.num_movies, loss_kind, device,
                        generator)
    trainer = models.Trainer(model, adam(1e-2))
    batcher = data.batched(lists, 1024, shuffle=True)
    state = trainer.init(generator, next(batcher()))
    state, history = trainer.fit(
        state, batcher, epochs=epochs, verbose=False
    )
    final = history["epochs"][-1]
    print(
        f"{loss_kind:>12}: NDCG={final['ndcg']:.4f} "
        f"NDCG@5={final['ndcg@5']:.4f}"
    )
    return final


def main(epochs: int = 2, device="cuda"):
    return {kind: run(kind, epochs, device)
            for kind in ("mse", "pairwise", "lambdarank", "list_mle",
                         "approx_ndcg")}


if __name__ == "__main__":
    main(device=parse_args().device)
