"""Base model + training loop: the Keras-fit replacement.

Port of `recommenders_tpu/models/base.py`, unsharded. The reference's
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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from recommenders_tpu_torch.metrics import base as metrics_base
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
      mesh: Must be None (the sharded trainer comes with the
        distribution slice).
      track_stats: Keep streaming loss and metric states in the train
        and eval steps. Off, `fit` reports the last step's loss and
        `evaluate` the mean total loss only.
    """

    model: Model
    optimizer: OptimizerLike
    mesh: Any = None
    track_stats: bool = True

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "The meshed Trainer is not ported yet (ROADMAP.md Queue A "
                "step 9)."
            )
        self._mean = metrics_base.Mean()
        self._optimizer: Optional[torch.optim.Optimizer] = None

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

    def _track(self, state: TrainState, batch, loss, reg, total, aux):
        """(metric states, loss states) after one step's outputs."""
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
            metric_states = self.model.update_metrics(
                state.metric_states, batch, aux)
        return metric_states, loss_states

    def train_step(self, state: TrainState, batch: Batch):
        """Runs one training step (parameters updated in place); returns
        `(state, total_loss)`."""
        if self._optimizer is None:
            raise ValueError("Call `init` before the first step.")
        batch = to_device(batch, self.device)[0]
        self.model.train()
        self._optimizer.zero_grad(set_to_none=True)
        loss, reg, aux = self._loss_and_aux(batch, training=True,
                                            generator=state.generator)
        total = loss + reg
        total.backward()
        self._optimizer.step()
        metric_states, loss_states = state.metric_states, state.loss_states
        if self.track_stats:
            metric_states, loss_states = self._track(
                state, batch, loss, reg, total, aux)
        return dataclasses.replace(
            state, step=state.step + 1, metric_states=metric_states,
            loss_states=loss_states,
        ), total.detach()

    def eval_step(self, state: TrainState, batch: Batch):
        """One evaluation step; returns `(state, total_loss)`."""
        batch = to_device(batch, self.device)[0]
        self.model.eval()
        with torch.no_grad():
            loss, reg, aux = self._loss_and_aux(batch, training=False)
            total = loss + reg
        if not self.track_stats:
            return state, total
        metric_states, loss_states = self._track(state, batch, loss, reg,
                                                 total, aux)
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
            value = m.result(state.metric_states[name])
            if isinstance(value, Mapping):
                results.update({k: float(v) for k, v in value.items()})
            else:
                results[name] = float(value)
        for name in _LOSS_METRICS:
            results[name] = float(self._mean.result(state.loss_states[name]))
        return results

    def _prefetched(self, dataset):
        """Yields device-resident batches, copying one step ahead.

        Batch i+1's host→device copy is issued (pinned memory,
        `non_blocking`, on a side stream) before batch i is handed out,
        so the copy overlaps step i; the consumer's stream waits for the
        copy before it reads the batch."""
        device = self.device
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        it = _iter_batches(dataset)
        try:
            pending = to_device(next(it), device, stream)
        except StopIteration:
            return
        for nxt in it:
            nxt = to_device(nxt, device, stream)
            yield wait_batch(*pending)
            pending = nxt
        yield wait_batch(*pending)

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
            for i, batch in enumerate(self._prefetched(dataset)):
                state, loss = self.train_step(state, batch)
                num_examples += _batch_size(batch)
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
