"""A pointwise ranking task.

Port of `recommenders_tpu/tasks/ranking.py`. The default loss is binary
cross-entropy with Keras' `sum_over_batch_size` reduction: the
per-element loss is averaged over trailing dims, optionally weighted per
example, then averaged over the batch. The task returns the loss with
the labels and predictions it read, for the metrics.

With a `mesh`, the task gathers the labels, predictions and weights of
the data axis's ranks (`utils.collectives.gather`) and computes
`loss_fn` over the global batch, so any `loss_fn` (a weighted mean, a
listwise loss) is the global batch's; the rank at coordinate 0 of the
axis carries it and the others carry zero, and the gather's backward
brings each rank the gradient of its own predictions.

The BCE on probabilities clips them to `[1e-7, 1 - 1e-7]` and takes
`log` / `log1p`, as the reference does
(`recommenders_tpu/tasks/ranking.py:47-49`);
`torch.nn.functional.binary_cross_entropy` clamps the log at -100
instead, which gives other values near 0 and 1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from recommenders_tpu_torch.utils import collectives
from recommenders_tpu_torch.tasks import base

Tensor = torch.Tensor

_EPS = 1e-7


def _sum_over_batch_size(per_elem: Tensor,
                         sample_weight: Optional[Tensor]) -> Tensor:
    """Mean over trailing dims, per-example weights, mean over the batch."""
    per_example = per_elem
    if per_elem.dim() > 1:
        per_example = torch.mean(per_elem, dim=tuple(range(1, per_elem.dim())))
    if sample_weight is not None:
        per_example = per_example * torch.reshape(
            sample_weight.to(per_example.dtype), per_example.shape)
    return torch.mean(per_example)


def binary_crossentropy(
    labels: Tensor,
    predictions: Tensor,
    sample_weight: Optional[Tensor] = None,
    from_logits: bool = False,
) -> Tensor:
    """Binary cross-entropy with `sum_over_batch_size` reduction."""
    labels = labels.to(torch.float32)
    predictions = predictions.to(torch.float32)
    if from_logits:
        per_elem = (
            torch.clamp(predictions, min=0.0)
            - predictions * labels
            + torch.log1p(torch.exp(-torch.abs(predictions)))
        )
    else:
        p = torch.clamp(predictions, _EPS, 1.0 - _EPS)
        per_elem = -(labels * torch.log(p)
                     + (1.0 - labels) * torch.log1p(-p))
    return _sum_over_batch_size(per_elem, sample_weight)


def mean_squared_error(
    labels: Tensor,
    predictions: Tensor,
    sample_weight: Optional[Tensor] = None,
) -> Tensor:
    """MSE with `sum_over_batch_size` reduction (Keras `MeanSquaredError`)."""
    labels = labels.to(torch.float32)
    predictions = predictions.to(torch.float32)
    return _sum_over_batch_size(torch.square(labels - predictions),
                                sample_weight)


class RankingOutput(NamedTuple):
    loss: Tensor
    labels: Tensor
    predictions: Tensor


@dataclasses.dataclass(frozen=True)
class Ranking(base.Task):
    """Pointwise ranking loss.

    Attributes:
      loss_fn: `(labels, predictions, sample_weight) -> scalar`; binary
        cross-entropy by default.
      mesh: Optional `parallel.Mesh`: the loss is this rank's share of
        the global batch's over `data_axis` (see the module docstring).
      data_axis: The mesh axis the batch is sharded over.
    """

    loss_fn: Callable[..., Tensor] = binary_crossentropy
    mesh: Any = None
    data_axis: str = collectives.DATA_AXIS

    def __call__(
        self,
        labels: Tensor,
        predictions: Tensor,
        sample_weight: Optional[Tensor] = None,
    ) -> RankingOutput:
        if collectives.axis_size(self.mesh, self.data_axis) == 1:
            loss = self.loss_fn(labels, predictions, sample_weight)
        else:
            loss = self._global_loss(labels, predictions, sample_weight)
        return RankingOutput(loss=loss, labels=labels,
                             predictions=predictions)

    def _global_loss(self, labels, predictions, sample_weight) -> Tensor:
        """`loss_fn` over the data axis's gathered batch on coordinate 0,
        zero (with the gather's gradient path) elsewhere."""
        def gathered(x):
            return (None if x is None
                    else collectives.gather(x, self.mesh, self.data_axis))

        loss = self.loss_fn(gathered(labels), gathered(predictions),
                            gathered(sample_weight))
        first = collectives.axis_index(self.mesh, self.data_axis) == 0
        return torch.where(torch.tensor(first, device=loss.device), loss,
                           torch.zeros_like(loss))
