"""Composite optimizer: different optimizers for disjoint parameter sets.

Port of `recommenders_tpu/optimizers/composite.py` (the counterpart of
the reference's `CompositeOptimizer`). Parameters are routed by
predicates over their path, the `named_parameters` name split at its
dots (e.g. "everything under `embedding`"); the first predicate that
matches wins, and a parameter no predicate matches is an error. Where
the JAX package builds an `optax.multi_transform`, this is one
`torch.optim.Optimizer` that owns one inner optimizer per predicate,
built by its factory over that predicate's parameters; its
`param_groups` are the inner optimizers' groups.

```python
opt = composite_optimizer([
    (lambda p: ClippyAdagrad(p, lr=0.05), path_contains("embedding")),
    (lambda p: torch.optim.Adam(p, lr=1e-3), lambda path: True),
], model.named_parameters())
```
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch

PathPredicate = Callable[[Tuple[str, ...]], bool]
OptimizerFactory = Callable[[List[torch.nn.Parameter]],
                            torch.optim.Optimizer]


def path_contains(*names: str) -> PathPredicate:
    """Predicate: some path component equals (or contains) one of
    `names`."""

    def pred(path: Tuple[str, ...]) -> bool:
        return any(any(n in part for n in names) for part in path)

    return pred


class _CompositeOptimizer(torch.optim.Optimizer):
    """One inner optimizer per predicate, over the parameters routed to
    it (built by `composite_optimizer`). `step`, `zero_grad`,
    `state_dict` and `load_state_dict` act on every inner optimizer in
    order."""

    def __init__(
        self,
        optimizers_and_predicates: Sequence[
            Tuple[OptimizerFactory, PathPredicate]],
        named_parameters: Iterable[Tuple[str, torch.nn.Parameter]],
    ) -> None:
        if not optimizers_and_predicates:
            raise ValueError("`optimizers_and_predicates` can't be empty")
        buckets: List[List[torch.nn.Parameter]] = [
            [] for _ in optimizers_and_predicates]
        for name, param in named_parameters:
            path = tuple(name.split("."))
            for i, (_, pred) in enumerate(optimizers_and_predicates):
                if pred(path):
                    buckets[i].append(param)
                    break
            else:
                raise ValueError(
                    f"Parameter at path {'/'.join(path)} is not handled by "
                    "any optimizer. This would cause it to be not trained."
                )
        # A predicate that matches nothing gets no optimizer (a torch
        # optimizer refuses an empty parameter list).
        self.optimizers: List[Optional[torch.optim.Optimizer]] = [
            factory(params) if params else None
            for (factory, _), params in zip(optimizers_and_predicates,
                                            buckets)
        ]
        super().__init__([p for params in buckets for p in params], {})
        self.param_groups = [group for opt in self._inner()
                             for group in opt.param_groups]

    def _inner(self) -> List[torch.optim.Optimizer]:
        return [opt for opt in self.optimizers if opt is not None]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for opt in self._inner():
            opt.step()
        return loss

    def zero_grad(self, set_to_none: bool = True) -> None:
        for opt in self._inner():
            opt.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> dict:
        return {"optimizers": [None if opt is None else opt.state_dict()
                               for opt in self.optimizers]}

    def load_state_dict(self, state_dict: dict) -> None:
        states = state_dict["optimizers"]
        if len(states) != len(self.optimizers):
            raise ValueError(
                f"state_dict holds {len(states)} optimizers, this one "
                f"{len(self.optimizers)}")
        for opt, state in zip(self.optimizers, states):
            if (opt is None) != (state is None):
                raise ValueError("state_dict routes parameters differently")
            if opt is not None:
                opt.load_state_dict(state)


def composite_optimizer(
    optimizers_and_predicates: Sequence[
        Tuple[OptimizerFactory, PathPredicate]],
    named_parameters: Iterable[Tuple[str, torch.nn.Parameter]],
) -> torch.optim.Optimizer:
    """Combines optimizers, routing each parameter to the first
    `(factory, predicate)` pair whose predicate takes its path. The
    result is one `torch.optim.Optimizer`; its `optimizers` are the
    inner ones in pair order (None for a pair that took no parameter).

    Raises:
      ValueError: If `optimizers_and_predicates` is empty, or some
        parameter matches no predicate.
    """
    return _CompositeOptimizer(optimizers_and_predicates, named_parameters)
