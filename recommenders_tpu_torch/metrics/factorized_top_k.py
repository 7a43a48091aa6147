"""Corpus-level factorized top-K retrieval metrics.

Port of `recommenders_tpu/metrics/factorized_top_k.py` (the counterpart
of `tfrs.metrics.FactorizedTopK`): top-K categorical accuracy at several
cutoffs against a retrieval index over the whole candidate corpus, in
both of the reference's modes:

  - score-based (no true ids): the positive's score (an elementwise
    sum) against the scores the index returns, with `tf.math.in_top_k`
    ties: strictly fewer than k retrieved scores above it;
  - id-based (true ids given): retrieved ids matched against the true
    ids, padding slots (`MIN_FLOAT` scores, the reference's NaN padding)
    ignored, several matches counted once. Needed for approximate
    indexes, whose scores are not exact dot products.

A state is one `Mean` state a cutoff, keyed by k.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence, Union

import torch

from recommenders_tpu_torch.layers import factorized_top_k as layers_ftk
from recommenders_tpu_torch.metrics import base as metrics_base
from recommenders_tpu_torch.utils import device as device_lib

Tensor = torch.Tensor
State = Any

DEFAULT_KS = (1, 5, 10, 50, 100)

class Factorized:
    """Base class for corpus-level factorized metrics."""


class FactorizedTopK(Factorized):
    """Top-K categorical accuracy over a candidate corpus.

    ```python
    metric = FactorizedTopK(
        candidates=BruteForce().index(corpus_embeddings),
        ks=(1, 5, 10, 50, 100),
    )
    state = metric.init()
    state = metric.update(state, query_embeddings, true_embeddings)
    metric.result(state)  # {"factorized_top_k/top_1_categorical_accuracy": ...}
    ```

    Args:
      candidates: A `TopK` index, or a raw `[n, d]` corpus tensor or an
        iterable of batches, which are wrapped in `Streaming(k=max(ks))`
        (on the corpus tensor's device, else on `device`).
      ks: Accuracy cutoffs.
      name: Prefix of the result names.
      device: Where a `Streaming` index over an iterable lives.
    """

    def __init__(
        self,
        candidates: Union[layers_ftk.TopK, Tensor, Iterable],
        ks: Sequence[int] = DEFAULT_KS,
        name: str = "factorized_top_k",
        device: device_lib.DeviceLike = "cuda",
    ) -> None:
        if not isinstance(candidates, layers_ftk.TopK):
            if isinstance(candidates, Tensor):
                device = candidates.device
            index = layers_ftk.Streaming(k=max(ks), device=device)
            if hasattr(candidates, "ndim"):
                index.index(candidates)
            else:
                index.index_from_dataset(candidates)
            candidates = index
        self._ks = tuple(ks)
        self._candidates = candidates
        self.name = name
        self._mean = metrics_base.Mean()

    @property
    def ks(self) -> Sequence[int]:
        return self._ks

    @property
    def candidates(self) -> layers_ftk.TopK:
        return self._candidates

    def metric_names(self) -> Sequence[str]:
        return [f"{self.name}/top_{k}_categorical_accuracy"
                for k in self._ks]

    def init(self) -> State:
        return {k: self._mean.init() for k in self._ks}

    def update(
        self,
        state: State,
        query_embeddings: Tensor,
        true_candidate_embeddings: Tensor,
        true_candidate_ids: Optional[Tensor] = None,
        sample_weight: Optional[Tensor] = None,
    ) -> State:
        """Updates every cutoff's accuracy state for a batch of queries."""
        if true_candidate_ids is None and not self._candidates.is_exact():
            raise ValueError(
                f"The candidate generation layer ({self._candidates}) does "
                "not return exact results. To perform evaluation using that "
                "layer, you must supply `true_candidate_ids`, which will be "
                "checked against the candidate ids returned from the "
                "candidate generation layer."
            )
        top_k_predictions, retrieved_ids = self._candidates(
            query_embeddings, k=max(self._ks))
        new_state = dict(state)
        if true_candidate_ids is not None:
            true_ids = torch.as_tensor(true_candidate_ids,
                                       device=retrieved_ids.device)
            if true_ids.dim() == 1:
                true_ids = true_ids[:, None]
            # Padding slots carry MIN_FLOAT in every index of the
            # package; unmasked, a padded slot's id could match.
            padding = top_k_predictions <= layers_ftk.MIN_FLOAT / 2
            ids_match = ((true_ids == retrieved_ids) & ~padding).to(
                torch.float32)
            for k in self._ks:
                found = torch.clamp(ids_match[:, :k].sum(1), 0.0, 1.0)
                new_state[k] = self._mean.update(state[k], found,
                                                 sample_weight)
            return new_state
        positive_scores = torch.sum(
            query_embeddings * true_candidate_embeddings, dim=1,
            keepdim=True).to(torch.float32)
        num_higher = torch.sum(top_k_predictions > positive_scores, dim=1)
        for k in self._ks:
            in_top_k = (num_higher < k).to(torch.float32)
            new_state[k] = self._mean.update(state[k], in_top_k,
                                             sample_weight)
        return new_state

    def result(self, state: State) -> Dict[str, Tensor]:
        return {name: self._mean.result(state[k])
                for name, k in zip(self.metric_names(), self._ks)}
