"""Prebuilt joint retrieval + ranking (multitask) model.

Port of `recommenders_tpu/models/multitask.py` (the reference's
multitask tutorial): a retrieval task and a rating-regression task over
shared towers, with scalar loss weights.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from recommenders_tpu_torch.metrics import base as metrics_base
from recommenders_tpu_torch.models import base as models_base
from recommenders_tpu_torch.models import ranking as ranking_model
from recommenders_tpu_torch.tasks import ranking as ranking_task
from recommenders_tpu_torch.tasks import retrieval as retrieval_task

Tensor = torch.Tensor

# The tutorial's rating head: Dense(256) → Dense(128) → Dense(1).
default_rating_head = ranking_model.mlp_stack((256, 128, 1))


class Multitask(models_base.Model):
    """Joint retrieval + rating model with weighted losses.

    Batches carry `query_key`, `candidate_key` and `rating_key` entries.
    A weight of 0 removes that task's gradient (the tutorial's
    retrieval-only / rating-only / joint sweep).

    Args:
      query_tower / candidate_tower: Tower modules (shared by the tasks)
        with an `out_features` width, e.g. `EmbeddingTower`.
      rating_head: Module over `concat([query_emb, candidate_emb])`;
        by default `default_rating_head`, built on the query tower's
        device.
      query_key / candidate_key / rating_key: Batch keys.
      retrieval_weight / rating_weight: Scalar loss weights.
      temperature: Retrieval softmax temperature.
      fused: Compute the retrieval loss with the flash-CE kernel K2
        (f32 scores); the logits never exist, so the batch top-k metric
        keeps its state.
      generator: Optional `torch.Generator` for the default head's
        weights.
    """

    def __init__(
        self,
        query_tower: nn.Module,
        candidate_tower: nn.Module,
        rating_head: Optional[nn.Module] = None,
        query_key: str = "user_id",
        candidate_key: str = "movie_id",
        rating_key: str = "user_rating",
        retrieval_weight: float = 1.0,
        rating_weight: float = 1.0,
        temperature: Optional[float] = None,
        fused: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.query_tower = query_tower
        self.candidate_tower = candidate_tower
        if rating_head is None:
            rating_head = default_rating_head(
                query_tower.out_features + candidate_tower.out_features,
                next(query_tower.parameters()).device, generator)
        self.rating_head = rating_head
        self.query_key = query_key
        self.candidate_key = candidate_key
        self.rating_key = rating_key
        self.retrieval_weight = retrieval_weight
        self.rating_weight = rating_weight
        self.retrieval_task = retrieval_task.Retrieval(
            temperature=temperature, fused=fused)
        self.rating_task = ranking_task.Ranking(
            loss_fn=ranking_task.mean_squared_error)

    def query_embeddings(self, batch: Mapping) -> Tensor:
        return self.query_tower(batch[self.query_key])

    def candidate_embeddings(self, batch: Mapping) -> Tensor:
        return self.candidate_tower(batch[self.candidate_key])

    def _rating(self, q: Tensor, c: Tensor) -> Tensor:
        return self.rating_head(torch.cat([q, c], dim=-1))[:, 0]

    def predict_rating(self, batch: Mapping) -> Tensor:
        return self._rating(self.query_embeddings(batch),
                            self.candidate_embeddings(batch))

    def shard_tasks(self, mesh, axis: str) -> None:
        """Both tasks on `axis` (see `models.Model.shard_tasks`); the
        loss is their weighted sum, which the ranks' shares keep."""
        self.retrieval_task = self.retrieval_task.on_mesh(mesh, axis)
        self.rating_task = self.rating_task.on_mesh(mesh, axis)

    def compute_loss(self, batch: Mapping, training: bool = False,
                     generator: Optional[torch.Generator] = None):
        q = self.query_embeddings(batch)
        c = self.candidate_embeddings(batch)
        weight = batch.get("sample_weight")
        retrieval_out = self.retrieval_task(q, c, sample_weight=weight)
        rating_out = self.rating_task(batch[self.rating_key],
                                      self._rating(q, c),
                                      sample_weight=weight)
        loss = (self.retrieval_weight * retrieval_out.loss
                + self.rating_weight * rating_out.loss)
        return loss, {"retrieval": retrieval_out, "rating": rating_out}

    def metrics(self) -> Dict[str, metrics_base.Metric]:
        return {
            "rating_rmse": metrics_base.RootMeanSquaredError(),
            "batch_top_10_categorical_accuracy":
                metrics_base.TopKCategoricalAccuracy(k=10),
        }

    def update_metrics(self, states, batch, aux):
        rating_out: ranking_task.RankingOutput = aux["rating"]
        retrieval_out: retrieval_task.RetrievalOutput = aux["retrieval"]
        weight = batch.get("sample_weight")
        m = self.metrics()
        new_states = {
            "rating_rmse": m["rating_rmse"].update(
                states["rating_rmse"], rating_out.labels,
                rating_out.predictions.detach(), weight),
        }
        top10 = "batch_top_10_categorical_accuracy"
        if retrieval_out.logits is None:
            # Fused: the logits never exist; the state carries over.
            new_states[top10] = states[top10]
        else:
            # The final (labels, logits) fed to the loss, as the
            # reference reads them (tasks/retrieval.py:230-234).
            new_states[top10] = m[top10].update(
                states[top10], retrieval_out.labels,
                retrieval_out.logits.detach(), weight)
        return new_states
