"""Data-parallel retrieval training with negatives pooled across ranks.

Port of `recommenders_tpu/parallel/retrieval_step.py`. Under plain data
parallelism each rank's in-batch softmax sees only its own candidates: a
global batch of B split over S ranks gives each query B/S negatives
instead of B. Here:

  - each rank embeds its local queries and candidates;
  - candidates are pooled across the data axis with
    `tasks.retrieval.cross_replica_concat` (all-gather + roll so the
    rank's own positives come first, and the identity labels hold);
  - every query scores the global candidate set (its positive plus B−1
    negatives), as one device running the global batch would;
  - gradients are summed over the axis; the all-gather's backward
    brings each rank the gradient of its candidate rows from every
    other rank's loss.

With sum-reduced softmax CE this equals the global batch's step on one
device. With `Retrieval(fused=True)` the loss runs K2 with B/S local
queries and C = B pooled candidates.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from recommenders_tpu_torch.models import base as models_base
from recommenders_tpu_torch.parallel import mesh as mesh_lib
from recommenders_tpu_torch.tasks import retrieval as retrieval_task
from recommenders_tpu_torch.utils.device import to_device

Tensor = torch.Tensor


def make_pooled_negatives_train_step(
    model,
    optimizer: torch.optim.Optimizer,
    mesh: mesh_lib.Mesh,
    data_axis: str = mesh_lib.DATA_AXIS,
) -> Callable:
    """Builds `batch → loss`: one pooled-negatives step.

    `model` follows the `TwoTowerRetrieval` contract
    (`query_embeddings`, `candidate_embeddings`, `task`); `batch` is this
    rank's slice of the global batch, on the model's device. The step
    updates the parameters in place (every rank the same way) and
    returns the global loss (the sum of the ranks' losses).
    """

    def step(batch) -> Tensor:
        optimizer.zero_grad(set_to_none=True)
        q = model.query_embeddings(batch)
        c = model.candidate_embeddings(batch)
        c_global = retrieval_task.cross_replica_concat(c, mesh, data_axis)
        loss = model.task(q, c_global).loss
        loss.backward()
        # Sum-reduced CE: the global loss is the sum of the ranks'
        # losses, and its gradient the sum of theirs.
        mesh_lib.sum_grads(model.parameters(), mesh, data_axis)
        optimizer.step()
        return mesh_lib.all_reduce(loss.detach(), mesh, data_axis)

    return step


@dataclasses.dataclass
class PooledNegativesTrainer(models_base.Trainer):
    """Trainer whose train step pools in-batch negatives across ranks.

    Drop-in for `Trainer` on retrieval models following the
    `TwoTowerRetrieval` contract. Metric and loss-state accumulation is
    off (the step returns the global loss). `mesh` is required.
    """

    def __post_init__(self):
        super().__post_init__()
        if self.mesh is None:
            raise ValueError("PooledNegativesTrainer needs a mesh.")
        self.track_stats = False
        self._pooled_step = None

    def _place_tasks(self, sharded: bool) -> None:
        """The model's task stays on one device: the step pools the
        candidates itself."""

    def train_step(self, state, batch):
        if self._optimizer is None:
            raise ValueError("Call `init` before the first step.")
        local, sharded = self._local(batch)
        if not sharded and self._data_size() > 1:
            raise ValueError(
                "PooledNegativesTrainer needs batches whose rows divide "
                "over the data axis.")
        return self._train_step(state, to_device(local, self.device)[0],
                                sharded)

    def _train_step(self, state, batch, sharded):
        if self._pooled_step is None:
            self._pooled_step = make_pooled_negatives_train_step(
                self.model, self._optimizer, self.mesh, self.data_axis)
        self.model.train()
        loss = self._pooled_step(batch)
        return dataclasses.replace(state, step=state.step + 1), loss
