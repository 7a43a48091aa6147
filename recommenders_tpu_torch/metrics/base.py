"""Streaming metrics: init / update / result over explicit states.

Port of `recommenders_tpu/metrics/base.py`. Every metric is a small
immutable object:

    state = metric.init()
    state = metric.update(state, ...)   # returns a new state
    value = metric.result(state)

States are dicts of f32 tensors, summable across shards
(`merge_states`). A fresh state lives on the CPU; `update` moves it to
the device of its inputs, so a state lives where the values it sums do
(one copy, at the first update).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, Optional

import torch

Tensor = torch.Tensor
State = Any


class Metric(abc.ABC):
    """Streaming metric interface: init / update / result."""

    name: str

    @abc.abstractmethod
    def init(self) -> State:
        ...

    @abc.abstractmethod
    def update(self, state: State, *args, **kwargs) -> State:
        ...

    @abc.abstractmethod
    def result(self, state: State) -> Tensor:
        ...


def _f32(x, device=None) -> Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def _zeros(*shape) -> Tensor:
    return torch.zeros(shape, dtype=torch.float32)


def _on(state: Dict[str, Tensor], device) -> Dict[str, Tensor]:
    return {k: v.to(device) for k, v in state.items()}


def _weighted(values, sample_weight):
    """Broadcasts weights against values; returns (weighted values,
    weights), both f32."""
    values = _f32(values)
    if sample_weight is None:
        weights = torch.ones_like(values)
    else:
        w = _f32(sample_weight, values.device)
        w = w.reshape(tuple(w.shape) + (1,) * (values.dim() - w.dim()))
        weights = torch.broadcast_to(w, values.shape)
    return values * weights, weights


@dataclasses.dataclass(frozen=True)
class Mean(Metric):
    """Weighted streaming mean (Keras `metrics.Mean` analog)."""

    name: str = "mean"

    def init(self) -> State:
        return {"total": _zeros(), "count": _zeros()}

    def update(self, state: State, values,
               sample_weight=None) -> State:
        weighted, weights = _weighted(values, sample_weight)
        state = _on(state, weighted.device)
        return {"total": state["total"] + torch.sum(weighted),
                "count": state["count"] + torch.sum(weights)}

    def result(self, state: State) -> Tensor:
        return state["total"] / torch.clamp(state["count"], min=1e-12)


@dataclasses.dataclass(frozen=True)
class Sum(Metric):
    """Weighted streaming sum."""

    name: str = "sum"

    def init(self) -> State:
        return {"total": _zeros()}

    def update(self, state, values, sample_weight=None) -> State:
        weighted, _ = _weighted(values, sample_weight)
        return {"total": state["total"].to(weighted.device)
                + torch.sum(weighted)}

    def result(self, state) -> Tensor:
        return state["total"]


@dataclasses.dataclass(frozen=True)
class RootMeanSquaredError(Metric):
    """Streaming RMSE over (labels, predictions)."""

    name: str = "rmse"

    def init(self) -> State:
        return Mean().init()

    def update(self, state, labels, predictions, sample_weight=None) -> State:
        predictions = _f32(predictions)
        sq = torch.square(_f32(labels, predictions.device) - predictions)
        return Mean().update(state, sq, sample_weight)

    def result(self, state) -> Tensor:
        return torch.sqrt(Mean().result(state))


@dataclasses.dataclass(frozen=True)
class MeanAbsoluteError(Metric):
    name: str = "mae"

    def init(self) -> State:
        return Mean().init()

    def update(self, state, labels, predictions, sample_weight=None) -> State:
        predictions = _f32(predictions)
        err = torch.abs(_f32(labels, predictions.device) - predictions)
        return Mean().update(state, err, sample_weight)

    def result(self, state) -> Tensor:
        return Mean().result(state)


@dataclasses.dataclass(frozen=True)
class BinaryAccuracy(Metric):
    """Fraction of `(pred > threshold) == label`."""

    threshold: float = 0.5
    name: str = "binary_accuracy"

    def init(self) -> State:
        return Mean().init()

    def update(self, state, labels, predictions, sample_weight=None) -> State:
        pred = (_f32(predictions) > self.threshold).to(torch.float32)
        match = (pred == _f32(labels, pred.device)).to(torch.float32)
        return Mean().update(state, match, sample_weight)

    def result(self, state) -> Tensor:
        return Mean().result(state)


@dataclasses.dataclass(frozen=True)
class CategoricalAccuracy(Metric):
    """argmax(pred) == argmax(label), per row (first maximum on ties)."""

    name: str = "categorical_accuracy"

    def init(self) -> State:
        return Mean().init()

    def update(self, state, labels, predictions, sample_weight=None) -> State:
        predictions = torch.as_tensor(predictions)
        labels = torch.as_tensor(labels, device=predictions.device)
        match = (torch.argmax(predictions, dim=-1)
                 == torch.argmax(labels, dim=-1)).to(torch.float32)
        return Mean().update(state, match, sample_weight)

    def result(self, state) -> Tensor:
        return Mean().result(state)


@dataclasses.dataclass(frozen=True)
class TopKCategoricalAccuracy(Metric):
    """Whether the true class is among the k highest-scoring predictions.

    Ties follow `tf.math.in_top_k`: the target is in the top k if
    strictly fewer than k entries score higher than it.
    """

    k: int = 5
    name: str = "top_k_categorical_accuracy"

    def init(self) -> State:
        return Mean().init()

    def update(self, state, labels, predictions, sample_weight=None) -> State:
        predictions = _f32(predictions)
        labels = torch.as_tensor(labels, device=predictions.device)
        target_idx = torch.argmax(labels, dim=-1)
        target_scores = torch.gather(predictions, -1, target_idx[:, None])
        num_higher = torch.sum(predictions > target_scores, dim=-1)
        in_top_k = (num_higher < self.k).to(torch.float32)
        return Mean().update(state, in_top_k, sample_weight)

    def result(self, state) -> Tensor:
        return Mean().result(state)


@dataclasses.dataclass(frozen=True)
class AUC(Metric):
    """Thresholded approximation of ROC-AUC (or PR-AUC).

    Keras-style: `num_thresholds` evenly spaced thresholds over [0, 1],
    streaming confusion-matrix counts, trapezoidal interpolation of the
    resulting curve. Predictions must be probabilities in [0, 1].
    """

    num_thresholds: int = 200
    curve: str = "ROC"
    name: str = "auc"

    def _thresholds(self, device) -> Tensor:
        eps = 1e-7
        inner = torch.arange(1, self.num_thresholds - 1,
                             dtype=torch.float32, device=device) / (
            self.num_thresholds - 1)
        return torch.cat([
            torch.tensor([-eps], dtype=torch.float32, device=device), inner,
            torch.tensor([1.0 + eps], dtype=torch.float32, device=device),
        ])

    def init(self) -> State:
        # Four distinct buffers, as in the JAX package (no aliasing).
        return {name: _zeros(self.num_thresholds)
                for name in ("tp", "fp", "tn", "fn")}

    def update(self, state, labels, predictions, sample_weight=None) -> State:
        predictions = _f32(predictions).reshape(-1)
        labels = _f32(labels, predictions.device).reshape(-1)
        if sample_weight is None:
            w = torch.ones_like(labels)
        else:
            w = torch.broadcast_to(
                _f32(sample_weight, labels.device).reshape(-1), labels.shape)
        state = _on(state, labels.device)
        # [T, N] prediction-above-threshold mask.
        above = predictions[None, :] > self._thresholds(labels.device)[:,
                                                                        None]
        pos = (labels * w)[None, :]
        neg = ((1.0 - labels) * w)[None, :]
        zero = torch.zeros((), device=labels.device)
        return {
            "tp": state["tp"] + torch.where(above, pos, zero).sum(1),
            "fp": state["fp"] + torch.where(above, neg, zero).sum(1),
            "fn": state["fn"] + torch.where(~above, pos, zero).sum(1),
            "tn": state["tn"] + torch.where(~above, neg, zero).sum(1),
        }

    def result(self, state) -> Tensor:
        tp, fp, tn, fn = (state["tp"], state["fp"], state["tn"],
                          state["fn"])
        if self.curve == "ROC":
            tpr = tp / torch.clamp(tp + fn, min=1e-12)
            fpr = fp / torch.clamp(fp + tn, min=1e-12)
            # Thresholds ascend => rates descend; integrate trapezoidally.
            return torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:])
                             / 2.0)
        if self.curve == "PR":
            # Precision with no predictions (highest thresholds) is 1.
            precision = torch.where(
                tp + fp > 0, tp / torch.clamp(tp + fp, min=1e-12),
                torch.ones((), device=tp.device))
            recall = tp / torch.clamp(tp + fn, min=1e-12)
            return torch.sum((recall[:-1] - recall[1:])
                             * (precision[:-1] + precision[1:]) / 2.0)
        raise ValueError(f"Unknown curve {self.curve!r}")


@dataclasses.dataclass(frozen=True)
class NDCG(Metric):
    """Streaming NDCG(@k) over `[B, L]` (labels, predictions) lists.

    Exponential gains `(2^label − 1) / log2(1 + rank)`; ties broken by
    list position (stable sort). Ragged lists through a boolean `mask`.
    """

    k: Optional[int] = None
    name: str = "ndcg"

    def init(self) -> State:
        return Mean().init()

    def update(self, state, labels, predictions, sample_weight=None,
               mask=None) -> State:
        predictions = _f32(predictions)
        device = predictions.device
        labels = _f32(labels, device)
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.bool, device=device)
        mask = torch.as_tensor(mask, device=device)
        length = labels.shape[1]
        cutoff = self.k if self.k is not None else length

        sort_key = torch.where(mask, predictions,
                               torch.tensor(float("-inf"), device=device))
        order = torch.argsort(-sort_key, dim=1, stable=True)
        zero = torch.zeros((), device=device)
        gains = torch.where(mask, torch.pow(2.0, labels) - 1.0, zero)
        sorted_gains = torch.gather(gains, 1, order)
        positions = torch.arange(1, length + 1, dtype=torch.float32,
                                 device=device)
        discounts = torch.where(positions <= cutoff,
                                1.0 / torch.log2(1.0 + positions), zero)
        dcg = torch.sum(sorted_gains * discounts[None], dim=1)
        ideal_gains = torch.sort(gains, dim=1, descending=True).values
        ideal = torch.sum(ideal_gains * discounts[None], dim=1)
        ndcg = torch.where(ideal > 0, dcg / torch.clamp(ideal, min=1e-12),
                           zero)
        return Mean().update(state, ndcg, sample_weight)

    def result(self, state) -> Tensor:
        return Mean().result(state)


def init_all(metrics: Dict[str, Metric]) -> Dict[str, State]:
    """Initializes a dict of metric states keyed like `metrics`."""
    return {name: m.init() for name, m in metrics.items()}


def result_all(
    metrics: Dict[str, Metric], states: Dict[str, State]
) -> Dict[str, Tensor]:
    return {name: m.result(states[name]) for name, m in metrics.items()}


def merge_states(state_a: State, state_b: State) -> State:
    """Merges two metric states by summation (valid for every metric
    here), leaf by leaf through nested dicts."""
    if isinstance(state_a, dict):
        return {k: merge_states(state_a[k], state_b[k]) for k in state_a}
    return state_a + state_b.to(state_a.device)
