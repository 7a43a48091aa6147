"""Base model + training loop: the Keras-fit replacement.

Port of `recommenders_tpu/models/base.py`. The reference's
`tfrs.Model` asks for one method, `compute_loss`, and derives the train
and test steps from it; so does this module:

  - `Model`: an `nn.Module` whose subclasses implement
    `compute_loss(batch, training, generator)` returning a scalar loss
    or `(loss, aux)`; optional `regularization_loss()`, and `metrics()`
    / `update_metrics(states, batch, aux)` for streaming metrics.
  - `Trainer`: owns the optimizer and runs eager train and eval steps;
    `fit` is a loop around them that copies the next batch to the device
    while the current step runs.

Where the JAX trainer is functional (a jitted step over a `TrainState`
pytree), this one updates the model's parameters and the optimizer's
state in place: `TrainState.params` holds the model's own tensors and
`opt_state` the optimizer. The per-step rng the JAX step splits into the
"dropout" and "sampling" streams is the state's `generator`, handed to
`compute_loss` every step.

`Trainer(mesh=...)` is data parallelism over the mesh's data axis, as
the JAX trainer's batch sharding: every rank calls the trainer with the
same global batches and takes its slice (`parallel.shard_batch`). The
trainer hands the mesh to the model's tasks (`Model.shard_tasks`), after
which the model's loss is this rank's share of the global batch's:
`tasks.Retrieval` pools the candidates across the axis and
`tasks.Ranking` computes its `loss_fn` over the gathered batch. The
shares and their gradients are summed over the data axis (one
collective a step) before the optimizer steps, and streaming metric
states are summed over it when read, so a step equals the global-batch
step. A model that does not implement `shard_tasks` is refused. A batch
that does not divide over the axis is replicated: the tasks go back to
one device and every rank runs it whole.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from recommenders_tpu_torch.metrics import base as metrics_base
from recommenders_tpu_torch.utils import collectives
from recommenders_tpu_torch.utils.device import to_device, wait_batch

Tensor = torch.Tensor
Batch = Any
Aux = Dict[str, Any]
OptimizerLike = Union[torch.optim.Optimizer,
                      Callable[[Any], torch.optim.Optimizer]]


class Model(nn.Module):
    """Base class for recommender models.

    Subclasses implement `compute_loss`:

    ```python
    class MovielensModel(rtpu.models.Model):
        def __init__(self, num_users, num_movies, dim=64):
            super().__init__()
            self.user_emb = nn.Embedding(num_users, dim)
            self.movie_emb = nn.Embedding(num_movies, dim)
            self.task = rtpu.tasks.Retrieval()

        def compute_loss(self, batch, training=False, generator=None):
            q = self.user_emb(batch["user_id"])
            c = self.movie_emb(batch["movie_id"])
            out = self.task(q, c)
            return out.loss, {"retrieval": out}
    ```
    """

    def compute_loss(
        self, batch: Batch, training: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Union[Tensor, Tuple[Tensor, Aux]]:
        """Defines the loss. `generator` drives any sampling or dropout
        of a training step."""
        raise NotImplementedError()

    def shard_tasks(self, mesh, axis: str) -> None:
        """Hands a data-parallel mesh to the model's tasks (None: back to
        one device).

        `Trainer(mesh=...)` calls it. Afterwards `compute_loss`, run on
        this rank's slice of a global batch, must return this rank's
        share of the global batch's loss: the shares sum over `axis` to
        it, and so do their gradients. `tasks.Retrieval` and
        `tasks.Ranking` compute such shares once they have the mesh
        (`Task.on_mesh`), so a model whose loss is a weighted sum of its
        tasks' losses implements this method by handing the mesh to each
        task, as the prebuilt models do. The base class raises: the
        trainer cannot split a loss it does not know (a mean the model
        takes itself would come out once per rank)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement shard_tasks, so "
            "Trainer(mesh=...) cannot split its loss over the data axis: "
            "compute the loss with tasks and hand them the mesh there "
            "(see models.Model.shard_tasks).")

    def regularization_loss(self) -> Tensor:
        """Optional additional loss (e.g. L2 on embeddings)."""
        param = next(self.parameters(), None)
        return torch.zeros((), device=None if param is None
                           else param.device)

    # --- Metric hooks -------------------------------------------------------

    def metrics(self) -> Dict[str, metrics_base.Metric]:
        """Declares streaming metrics updated each step."""
        return {}

    def update_metrics(
        self, states: Dict[str, Any], batch: Batch, aux: Aux
    ) -> Dict[str, Any]:
        """Returns new metric states given the step's aux outputs."""
        return states


@dataclasses.dataclass
class TrainState:
    """All training state.

    `params` are the model's parameters (its own tensors, updated in
    place by every step) and `opt_state` the optimizer holding its
    state; `generator` drives sampling and dropout in `compute_loss`.
    """

    step: int
    params: Dict[str, Tensor]
    opt_state: torch.optim.Optimizer
    metric_states: Any
    loss_states: Any  # Streaming means of loss / regularization / total.
    generator: Optional[torch.Generator] = None


_LOSS_METRICS = ("loss", "regularization_loss", "total_loss")


@dataclasses.dataclass
class Trainer:
    """Drives train and eval steps for a `Model`.

    Attributes:
      model: The model; its parameters' device is where batches go.
      optimizer: A `torch.optim.Optimizer` over the model's parameters,
        or a factory `parameters -> Optimizer` that `init` calls.
      mesh: Optional `parallel.Mesh`: data parallelism over its
        `data_axis` (see the module docstring). None trains on one
        device.
      track_stats: Keep streaming loss and metric states in the train
        and eval steps. Off, `fit` reports the last step's loss and
        `evaluate` the mean total loss only.
      data_axis: The mesh axis the batch is sharded over.
    """

    model: Model
    optimizer: OptimizerLike
    mesh: Any = None
    track_stats: bool = True
    data_axis: str = collectives.DATA_AXIS

    def __post_init__(self):
        collectives.check_mesh(self.mesh, "Trainer")
        self._mean = metrics_base.Mean()
        self._optimizer: Optional[torch.optim.Optimizer] = None
        self._tasks_sharded = False
        self._place_tasks(self._data_size() > 1)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # --- Initialization -----------------------------------------------------

    def init(
        self,
        generator: Optional[torch.Generator] = None,
        sample_batch: Optional[Batch] = None,
    ) -> TrainState:
        """Builds the optimizer and a fresh `TrainState`.

        The port's modules draw their weights when built (from the
        generator they are given); `sample_batch`, if given, runs one
        forward pass without gradients, which materializes lazy modules.
        The state's step generator lives on the model's device and is
        seeded from `generator` (a fixed seed when None).
        """
        if sample_batch is not None:
            self._place_tasks(False)
            with torch.no_grad():
                self.model.compute_loss(
                    to_device(sample_batch, self.device)[0], training=True,
                    generator=torch.Generator(self.device).manual_seed(0))
        if isinstance(self.optimizer, torch.optim.Optimizer):
            self._optimizer = self.optimizer
        else:
            self._optimizer = self.optimizer(self.model.parameters())
        seed = (0 if generator is None else int(torch.randint(
            0, 2**62, (), generator=generator, device=generator.device)))
        step_generator = torch.Generator(self.device).manual_seed(seed)
        metric_objs = self.model.metrics() if self.track_stats else {}
        return TrainState(
            step=0,
            params=dict(self.model.named_parameters()),
            opt_state=self._optimizer,
            metric_states=metrics_base.init_all(metric_objs),
            loss_states=(
                {name: self._mean.init() for name in _LOSS_METRICS}
                if self.track_stats else {}
            ),
            generator=step_generator,
        )

    # --- Steps ----------------------------------------------------------------

    def _loss_and_aux(self, batch, training: bool, generator=None):
        out = self.model.compute_loss(batch, training=training,
                                      generator=generator)
        loss, aux = out if isinstance(out, tuple) else (out, {})
        return loss, self.model.regularization_loss(), aux

    # --- Data parallelism -----------------------------------------------------

    def _data_size(self) -> int:
        return collectives.axis_size(self.mesh, self.data_axis)

    def _local(self, batch: Batch) -> Tuple[Batch, bool]:
        """(this rank's slice of a global batch, whether it is a slice);
        a batch that does not divide over the data axis stays whole."""
        if self._data_size() == 1 or not collectives.batch_shardable(
                batch, self.mesh, self.data_axis):
            return batch, False
        return collectives.shard_batch(batch, self.mesh, self.data_axis), True

    def _place_tasks(self, sharded: bool) -> None:
        """The model's tasks on the mesh for a step on this rank's slice,
        on one device for a step every rank runs whole."""
        if sharded != self._tasks_sharded:
            self.model.shard_tasks(self.mesh if sharded else None,
                                   self.data_axis)
            self._tasks_sharded = sharded

    def _sum_over_data(self, x: Tensor) -> Tensor:
        return collectives.all_reduce(x, self.mesh, self.data_axis)

    def _track(self, state: TrainState, batch, loss, reg, total, aux,
               sharded: bool = False):
        """(metric states, loss states) after one step's outputs. The
        loss states take the global loss; the metric states this rank's
        slice (summed over the data axis when read), and a batch every
        rank ran whole counts on the first rank of the axis only."""
        own = sharded or collectives.axis_index(self.mesh, self.data_axis) == 0
        with torch.no_grad():
            loss_states = {
                "loss": self._mean.update(state.loss_states["loss"],
                                          loss.detach()),
                "regularization_loss": self._mean.update(
                    state.loss_states["regularization_loss"],
                    reg.detach()),
                "total_loss": self._mean.update(
                    state.loss_states["total_loss"], total.detach()),
            }
            metric_states = (self.model.update_metrics(
                state.metric_states, batch, aux) if own
                else state.metric_states)
        return metric_states, loss_states

    def train_step(self, state: TrainState, batch: Batch):
        """Runs one training step (parameters updated in place); returns
        `(state, total_loss)`. With a mesh, `batch` is the global batch
        (every rank passes the same one)."""
        if self._optimizer is None:
            raise ValueError("Call `init` before the first step.")
        batch, sharded = self._local(batch)
        return self._train_step(state, to_device(batch, self.device)[0],
                                sharded)

    def _train_step(self, state: TrainState, batch: Batch, sharded: bool):
        self.model.train()
        self._optimizer.zero_grad(set_to_none=True)
        self._place_tasks(sharded)
        loss, reg, aux = self._loss_and_aux(batch, training=True,
                                            generator=state.generator)
        if sharded:
            # Every rank adds the replicated regularization; its share
            # makes the ranks' sum count it once.
            (loss + reg / self._data_size()).backward()
            collectives.sum_grads(self.model.parameters(), self.mesh,
                                  self.data_axis)
            loss = self._sum_over_data(loss.detach())
        else:
            (loss + reg).backward()
        self._optimizer.step()
        total = loss + reg
        metric_states, loss_states = state.metric_states, state.loss_states
        if self.track_stats:
            metric_states, loss_states = self._track(
                state, batch, loss, reg, total, aux, sharded)
        return dataclasses.replace(
            state, step=state.step + 1, metric_states=metric_states,
            loss_states=loss_states,
        ), total.detach()

    def eval_step(self, state: TrainState, batch: Batch):
        """One evaluation step; returns `(state, total_loss)`."""
        batch, sharded = self._local(batch)
        batch = to_device(batch, self.device)[0]
        self.model.eval()
        self._place_tasks(sharded)
        with torch.no_grad():
            loss, reg, aux = self._loss_and_aux(batch, training=False)
            if sharded:
                loss = self._sum_over_data(loss)
            total = loss + reg
        if not self.track_stats:
            return state, total
        metric_states, loss_states = self._track(state, batch, loss, reg,
                                                 total, aux, sharded)
        return dataclasses.replace(
            state, metric_states=metric_states, loss_states=loss_states,
        ), total

    # --- Loops ----------------------------------------------------------------

    def reset_metrics(self, state: TrainState) -> TrainState:
        if not self.track_stats:
            return state
        return dataclasses.replace(
            state,
            metric_states=metrics_base.init_all(self.model.metrics()),
            loss_states={name: self._mean.init() for name in _LOSS_METRICS},
        )

    def metric_results(self, state: TrainState) -> Dict[str, float]:
        if not self.track_stats:
            return {}
        results = {}
        for name, m in self.model.metrics().items():
            mstate = state.metric_states[name]
            if self._data_size() > 1:
                mstate = {k: self._sum_over_data(v.to(self.device))
                          for k, v in mstate.items()}
            value = m.result(mstate)
            if isinstance(value, Mapping):
                results.update({k: float(v) for k, v in value.items()})
            else:
                results[name] = float(value)
        for name in _LOSS_METRICS:
            results[name] = float(self._mean.result(state.loss_states[name]))
        return results

    def _prefetched_steps(self, dataset):
        """Yields `(device batch, sharded, global rows)`, copying one step
        ahead: with a mesh, this rank's slice of each global batch.

        Batch i+1's host→device copy is issued (pinned memory,
        `non_blocking`, on a side stream) before batch i is handed out,
        so the copy overlaps step i; the consumer's stream waits for the
        copy before it reads the batch."""
        device = self.device
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        it = _iter_batches(dataset)

        def copy(batch):
            rows = _batch_size(batch)
            local, sharded = self._local(batch)
            return to_device(local, device, stream), sharded, rows

        try:
            pending = copy(next(it))
        except StopIteration:
            return
        for nxt in it:
            nxt = copy(nxt)
            yield (wait_batch(*pending[0]),) + pending[1:]
            pending = nxt
        yield (wait_batch(*pending[0]),) + pending[1:]

    def fit(
        self,
        state: TrainState,
        dataset: Callable[[], Any],
        epochs: int = 1,
        verbose: bool = True,
        max_in_flight: int = 10,
        validation_data: Optional[Callable[[], Any]] = None,
    ) -> Tuple[TrainState, Dict[str, Any]]:
        """Trains for `epochs` passes over `dataset` (a batch-iterator
        factory, or an iterable).

        Batches are copied to the device one step ahead, and the host
        waits for the loss every `max_in_flight` steps (and once at the
        end), bounding how far it runs ahead of the device.

        With `validation_data` (another batch factory), an evaluation
        pass runs after every epoch and its metrics join the history
        with a `val_` prefix.

        Returns the final state and a history dict with per-epoch metric
        results and throughput (`examples_per_sec`).
        """
        if self._optimizer is None:
            raise ValueError("Call `init` before `fit`.")
        history = {"epochs": []}
        for epoch in range(epochs):
            state = self.reset_metrics(state)
            start = time.perf_counter()
            num_examples = 0
            loss = None
            for i, (batch, sharded, rows) in enumerate(
                    self._prefetched_steps(dataset)):
                state, loss = self._train_step(state, batch, sharded)
                num_examples += rows
                if (i + 1) % max_in_flight == 0:
                    loss.item()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            elapsed = time.perf_counter() - start
            results = self.metric_results(state)
            if loss is not None:
                results.setdefault("loss", float(loss))
            results["examples_per_sec"] = num_examples / max(elapsed, 1e-9)
            if validation_data is not None:
                val_results = self.evaluate(state, validation_data)
                results.update(
                    {f"val_{k}": v for k, v in val_results.items()})
            history["epochs"].append(results)
            if verbose:
                summary = ", ".join(
                    f"{k}={v:.4f}" for k, v in sorted(results.items()))
                print(f"epoch {epoch + 1}/{epochs}: {summary}")
        return state, history

    def evaluate(
        self, state: TrainState, dataset: Callable[[], Any]
    ) -> Dict[str, float]:
        """Evaluates over one pass of `dataset`; returns metric results.

        With `track_stats=False` there are no streaming states, so the
        result is the mean over steps of the total loss, as
        `total_loss`."""
        state = self.reset_metrics(state)
        if not self.track_stats:
            loss_sum, steps = 0.0, 0
            for batch in _iter_batches(dataset):
                state, total = self.eval_step(state, batch)
                loss_sum += float(total)
                steps += 1
            return {"total_loss": loss_sum / max(steps, 1)}
        for batch in _iter_batches(dataset):
            state, _ = self.eval_step(state, batch)
        return self.metric_results(state)


def _iter_batches(dataset):
    return iter(dataset() if callable(dataset) else dataset)


def _batch_size(batch) -> int:
    """Rows of the batch's first leaf in sorted key order (JAX's
    `tree_leaves` order)."""
    if isinstance(batch, Mapping):
        if not batch:
            return 0
        batch = batch[sorted(batch)[0]]
    return int(np.shape(batch)[0])
