"""A factorized retrieval task: in-batch sampled softmax.

Port of `recommenders_tpu/tasks/retrieval.py:38-246`. Scoring:

  - `scores = Q @ Cᵀ` in f32, or maxsim over heads for `[q, heads, d]`
    queries;
  - identity labels `eye(num_queries, num_candidates)`, so extra rows of
    the candidates are shared extra negatives;
  - optional temperature, log-q correction, accidental-hit removal,
    score mask and hard-negative mining, in that order;
  - softmax cross-entropy summed over the batch, with optional per-query
    weights.

With `score_dtype` (e.g. `torch.bfloat16`) the embeddings are rounded to
that dtype and the score matrix is f32: the products of bf16 values are
exact in f32, so the scores are computed from the rounded inputs cast to
f32, with TF32 off. `torch.matmul` on two bf16 tensors would round the
scores to bf16.

`Retrieval(fused=True)` computes the same loss with the flash-CE kernel
K2 (`ops/fused_retrieval.py`) and returns only the loss.
With a `mesh`, the candidates (their ids and sampling probabilities) of
the data axis's ranks are pooled with `cross_replica_concat`, so every
query scores the global batch's candidates; the loss, summed over this
rank's queries, is its share of the global batch's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from recommenders_tpu_torch.layers import loss as loss_layers
from recommenders_tpu_torch.ops import fused_retrieval
from recommenders_tpu_torch.ops import scoring
from recommenders_tpu_torch.utils import collectives
from recommenders_tpu_torch.tasks import base

Tensor = torch.Tensor

MIN_FLOAT = loss_layers.MIN_FLOAT


def softmax_cross_entropy(
    labels: Tensor,
    logits: Tensor,
    sample_weight: Optional[Tensor] = None,
) -> Tensor:
    """Softmax cross-entropy, summed over the batch: per-row CE of the
    (possibly soft) labels against `log_softmax(logits)`, weighted per
    row, then summed."""
    log_probs = torch.log_softmax(logits, dim=-1)
    per_example = -torch.sum(labels * log_probs, dim=-1)
    if sample_weight is not None:
        per_example = per_example * torch.reshape(
            sample_weight, per_example.shape
        )
    return torch.sum(per_example)


class RetrievalOutput(NamedTuple):
    """Output of the retrieval task.

    Attributes:
      loss: Scalar loss (summed over the batch).
      logits: `[num_queries, num_kept]` logits fed to the loss.
      labels: `[num_queries, num_kept]` labels aligned with `logits`.
      scores: `[num_queries, num_candidates]` post-temperature scores.

    With `Retrieval(fused=True)` only `loss` is set.
    """

    loss: Tensor
    logits: Optional[Tensor]
    labels: Optional[Tensor]
    scores: Optional[Tensor]


@dataclasses.dataclass(frozen=True)
class Retrieval(base.Task):
    """In-batch sampled-softmax retrieval loss.

    Attributes:
      loss_fn: `(labels, logits, sample_weight) -> scalar`; defaults to
        softmax CE with SUM reduction.
      temperature: Scores are divided by it.
      num_hard_negatives: Keep only this many highest-scoring negatives
        (plus the positive) per query.
      remove_accidental_hits: Mask in-batch negatives sharing the
        positive's candidate id (needs `candidate_ids`).
      score_dtype: Optional dtype the embeddings are rounded to before
        scoring; the scores and the loss stay f32.
      fused: Compute the loss with the flash-CE kernel K2; the `[B, C]`
        score matrix is never built. Maxsim queries, hard negatives,
        score masks and another `loss_fn` raise. Only `loss` is set in
        the output.
      mesh: Optional `parallel.Mesh`: pool the candidates across
        `data_axis` (see the module docstring). Takes the default summed
        softmax CE only, with no score mask.
      data_axis: The mesh axis the batch is sharded over.
    """

    loss_fn: Callable[..., Tensor] = softmax_cross_entropy
    temperature: Optional[float] = None
    num_hard_negatives: Optional[int] = None
    remove_accidental_hits: bool = False
    score_dtype: Optional[torch.dtype] = None
    fused: bool = False
    mesh: Any = None
    data_axis: str = collectives.DATA_AXIS

    def __call__(
        self,
        query_embeddings: Tensor,
        candidate_embeddings: Tensor,
        sample_weight: Optional[Tensor] = None,
        candidate_sampling_probability: Optional[Tensor] = None,
        candidate_ids: Optional[Tensor] = None,
        score_mask: Optional[Tensor] = None,
    ) -> RetrievalOutput:
        """Computes the retrieval loss.

        Args:
          query_embeddings: `[num_queries, dim]`, or
            `[num_queries, num_heads, dim]` for maxsim scoring.
          candidate_embeddings: `[num_candidates, dim]`, num_candidates ≥
            num_queries; row i is query i's positive.
          sample_weight: Optional `[num_queries]` weights.
          candidate_sampling_probability: Optional `[num_candidates]`
            probabilities for the log-q correction.
          candidate_ids: Optional `[num_candidates]` ids, required with
            `remove_accidental_hits`.
          score_mask: Optional `[num_queries, num_candidates]` boolean
            mask; False entries are excluded from the loss.

        With a `mesh` the candidates, their ids and sampling
        probabilities are pooled across the data axis with
        `cross_replica_concat`, so every query scores the global batch's
        candidates and the ranks' losses sum to the global batch's.
        """
        if collectives.axis_size(self.mesh, self.data_axis) > 1:
            if score_mask is not None:
                raise ValueError(
                    "A score mask covers this rank's candidates only; it "
                    "cannot be pooled across the data axis.")
            if self.loss_fn is not softmax_cross_entropy:
                raise ValueError(
                    "Retrieval(mesh=...) splits the summed softmax CE "
                    "over the ranks' queries; another loss_fn need not "
                    "split, so it is refused.")
            pool = (self.mesh, self.data_axis)
            candidate_embeddings = cross_replica_concat(
                candidate_embeddings, *pool)
            if candidate_ids is not None:
                candidate_ids = cross_replica_concat(candidate_ids, *pool)
            if candidate_sampling_probability is not None:
                candidate_sampling_probability = cross_replica_concat(
                    candidate_sampling_probability, *pool)
        if self.fused:
            if (
                query_embeddings.dim() != 2
                or self.num_hard_negatives is not None
                or score_mask is not None
                or self.loss_fn is not softmax_cross_entropy
            ):
                raise ValueError(
                    "Retrieval(fused=True) supports 2D queries with the "
                    "default softmax CE loss and no hard-negative "
                    "mining or score mask; use the unfused task for "
                    "those knobs."
                )
            loss = fused_retrieval.fused_retrieval_loss(
                query_embeddings,
                candidate_embeddings,
                sample_weight=sample_weight,
                candidate_sampling_probability=candidate_sampling_probability,
                candidate_ids=candidate_ids,
                temperature=self.temperature,
                remove_accidental_hits=self.remove_accidental_hits,
                score_dtype=self.score_dtype,
            )
            return RetrievalOutput(loss=loss, logits=None, labels=None,
                                   scores=None)
        q, c = query_embeddings, candidate_embeddings
        if self.score_dtype is not None:
            q = q.to(self.score_dtype)
            c = c.to(self.score_dtype)
        if q.dim() == 3:
            # Maxsim: best head per (query, candidate) pair.
            nq, heads, dim = q.shape
            scores = scoring.reference_scores(q.reshape(nq * heads, dim), c)
            scores = scores.view(nq, heads, -1).max(dim=1).values
        else:
            scores = scoring.reference_scores(q, c)

        num_queries, num_candidates = scores.shape
        labels = torch.eye(num_queries, num_candidates, dtype=scores.dtype,
                           device=scores.device)
        if self.temperature is not None:
            scores = loss_layers.divide_by_temperature(scores,
                                                       self.temperature)
        batch_scores = scores
        logits = scores
        if candidate_sampling_probability is not None:
            logits = loss_layers.sampling_probability_correction(
                logits, candidate_sampling_probability
            )
        if self.remove_accidental_hits:
            if candidate_ids is None:
                raise ValueError(
                    "When accidental hit removal is enabled, candidate ids "
                    "must be supplied."
                )
            logits = loss_layers.remove_accidental_hits(
                labels, logits, candidate_ids
            )
        if score_mask is not None:
            logits = torch.where(score_mask, logits,
                                 torch.tensor(MIN_FLOAT, dtype=logits.dtype,
                                              device=logits.device))
        out_labels = labels
        if self.num_hard_negatives is not None:
            logits, out_labels = loss_layers.hard_negative_mining(
                logits, labels, self.num_hard_negatives
            )
        loss = self.loss_fn(out_labels, logits, sample_weight)
        return RetrievalOutput(
            loss=loss, logits=logits, labels=out_labels, scores=batch_scores
        )


def cross_replica_concat(values: Tensor, mesh: "collectives.Mesh",
                         axis: str = collectives.DATA_AXIS) -> Tensor:
    """All-gathers `values` across a mesh axis, own rows first.

    Counterpart of `recommenders_tpu/tasks/retrieval.py:249-263` and of
    the reference's `_cross_replica_concat`: each rank's `[b, ...]`
    values are gathered along axis 0 in axis order, then rolled by
    `axis_index · b` so this rank's contribution comes first. Used to
    pool in-batch negatives across data-parallel ranks while each rank's
    own positives stay on the diagonal. Differentiable: gradients come
    out as JAX's do (the backward sums the cotangents over the axis).
    """
    if collectives.axis_size(mesh, axis) == 1:
        return values
    shift = collectives.axis_index(mesh, axis) * values.shape[0]
    return torch.roll(collectives.gather(values, mesh, axis), -shift, dims=0)
