"""Clippy Adagrad: Adagrad with per-variable adaptive clipping.

Port of `recommenders_tpu/optimizers/clippy_adagrad.py` (the counterpart
of the reference's `ClippyAdagrad`, https://arxiv.org/pdf/2302.09178.pdf)
as a `torch.optim.Optimizer`. For each parameter w, the Adagrad step is
scaled by the largest factor in (0, 1] that keeps, elementwise,

    |Δw| <= |w|·variable_relative_threshold
            + rsqrt(accum)·accumulator_relative_threshold
            + absolute_threshold,

with delayed (the default) or standard accumulator updates, and
optionally the accumulator update clipped by the same factor. Each
parameter's state holds its `accumulator` and its last
`clipping_factor` (the reference's exported clipping factors);
`state["count"]` is the optimizer's one step count, as optax keeps it,
and a learning rate may be a callable of that count. A parameter
without a gradient at a step is treated as optax treats a zero
gradient: it does not move, its accumulator keeps its value and its
clipping factor is 1.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence, Tuple, Union

import torch

Tensor = torch.Tensor
ScalarOrSchedule = Union[float, Callable[[int], float]]


def shrink_by_references(
    tensor: Tensor,
    references: Sequence[Tensor],
    relative_factors: Sequence[float],
    absolute_factor: float,
) -> Tuple[Tensor, Tensor]:
    """`(tensor · scale, scale)`, with `scale` the largest scalar in
    (0, 1] such that `|tensor|·scale <= Σ_j |reference_j|·rel_j + abs`
    elementwise (the reference's `shrink_by_references`)."""
    if any(rf < 0 for rf in relative_factors):
        raise ValueError("relative_factors must all be non-negative.")
    if absolute_factor < 0:
        raise ValueError("absolute_factor must be non-negative.")
    if len(references) != len(relative_factors):
        raise ValueError(
            "references and relative_factors must have the same length. "
            f"Instead they are {len(references)} and "
            f"{len(relative_factors)}."
        )
    max_delta = absolute_factor
    for ref, rf in zip(references, relative_factors):
        max_delta = max_delta + torch.abs(ref) * rf
    abs_tensor = torch.abs(tensor)
    per_element_scale = torch.where(
        tensor == 0.0, 1.0,
        torch.where(abs_tensor > 0.0, max_delta / abs_tensor, 1.0))
    scale = torch.clamp(torch.min(per_element_scale), max=1.0)
    return tensor * scale, scale


class ClippyAdagrad(torch.optim.Optimizer):
    """Clippy Adagrad.

    Args:
      params: Parameters or parameter groups.
      lr: Float, or a callable `count -> lr` of the optimizer's step
        count (0 at the first step).
      initial_accumulator_value: Starting value of the accumulators.
      variable_relative_threshold: Clipping threshold relative to |w|.
      accumulator_relative_threshold: Threshold relative to
        rsqrt(accum).
      absolute_threshold: Absolute clipping threshold.
      epsilon: Added to the accumulator under the root.
      clip_accumulator_update: Scale the accumulator's update by the
        clipping factor too (delayed mode only).
      use_standard_accumulator_update: Update the accumulator before the
        step, as classical Adagrad does. Excludes
        `clip_accumulator_update`.
    """

    def __init__(
        self,
        params: Iterable,
        lr: ScalarOrSchedule = 0.001,
        initial_accumulator_value: float = 0.1,
        variable_relative_threshold: float = 0.1,
        accumulator_relative_threshold: float = 0.0,
        absolute_threshold: float = 1e-7,
        epsilon: float = 1e-7,
        clip_accumulator_update: bool = False,
        use_standard_accumulator_update: bool = False,
    ) -> None:
        if clip_accumulator_update and use_standard_accumulator_update:
            raise ValueError(
                "clip_accumulator_update and use_standard_accumulator_update "
                "cannot both be set to True."
            )
        defaults = dict(
            lr=lr,
            initial_accumulator_value=initial_accumulator_value,
            variable_relative_threshold=variable_relative_threshold,
            accumulator_relative_threshold=accumulator_relative_threshold,
            absolute_threshold=absolute_threshold,
            epsilon=epsilon,
            clip_accumulator_update=clip_accumulator_update,
            use_standard_accumulator_update=use_standard_accumulator_update,
        )
        super().__init__(params, defaults)

    def _state(self, p: Tensor, group) -> dict:
        state = self.state[p]
        if not state:
            state["accumulator"] = torch.full_like(
                p, group["initial_accumulator_value"],
                memory_format=torch.preserve_format)
            state["clipping_factor"] = torch.ones((), dtype=p.dtype,
                                                  device=p.device)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        count = self.state.get("count", 0)
        for group in self.param_groups:
            standard = group["use_standard_accumulator_update"]
            lr = group["lr"]
            if callable(lr):
                lr = lr(count)
            for p in group["params"]:
                state = self._state(p, group)
                if p.grad is None:
                    state["clipping_factor"].fill_(1.0)
                    continue
                g = p.grad
                accum = state["accumulator"]
                if standard:
                    accum = accum + torch.square(g)
                precondition = 1.0 / torch.sqrt(accum + group["epsilon"])
                delta = lr * g * precondition
                clipped, factor = shrink_by_references(
                    delta,
                    references=[p, precondition],
                    relative_factors=[
                        group["variable_relative_threshold"],
                        group["accumulator_relative_threshold"],
                    ],
                    absolute_factor=group["absolute_threshold"],
                )
                if not standard:
                    acc_update = (g * factor if group["clip_accumulator_update"]
                                  else g)
                    accum = accum + torch.square(acc_update)
                state["accumulator"].copy_(accum)
                state["clipping_factor"].copy_(factor)
                p.sub_(clipped)
        self.state["count"] = count + 1
        return loss
