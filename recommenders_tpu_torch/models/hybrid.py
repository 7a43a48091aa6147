"""Hybrid trainer: a dense model under a torch optimizer over the tables
of an embedding engine.

Port of `recommenders_tpu/models/hybrid.py`, the production DLRM split:
big embedding tables live in an `EmbeddingEngine` and are updated by its
row-sparse optimizer (K1, `csrc/sparse_apply.cu`, on the card), while
the dense model trains through an ordinary optimizer. Each step
differentiates the loss with respect to both the dense parameters and
the embedding activations; the optimizer steps the former, the engine's
`update` applies the latter.

```python
class DenseModel(nn.Module):
    def forward(self, batch, acts):
        x = torch.cat([acts["user_id"], acts["item_id"]], -1)
        return ranking_task(batch["clicked"], mlp(x)).loss

trainer = HybridTrainer(DenseModel(), engine,
                        lambda p: torch.optim.Adam(p, 1e-3))
state = trainer.init(torch.Generator("cuda").manual_seed(0))
state, loss, aux = trainer.train_step(state, batch)
```

The dense model's `forward(batch, activations)` returns a scalar loss or
`(loss, aux)`. `init` starts from fresh tables, or from a given engine
state and optimizer `state_dict`. With `pipelined=True` the engine's update runs one step
stale (call `finalize` after the last step). As in the JAX step, a step
looks its activations up in the tables BEFORE it applies the pending
update (`recommenders_tpu/models/hybrid.py:108-118`); the engine updates
its tables in place, and `lookup` returns gathered copies, so the
activations keep the values they were read with.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from recommenders_tpu_torch.embedding import engine as engine_lib
from recommenders_tpu_torch.utils.device import to_device

Tensor = torch.Tensor
OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


@dataclasses.dataclass
class HybridState:
    """Dense parameters and optimizer, engine state, pending update.

    `params` are the model's own parameters (updated in place), and
    `opt_state` the optimizer holding its state."""

    params: Dict[str, Tensor]
    opt_state: torch.optim.Optimizer
    engine_state: engine_lib.EngineState
    pending: Optional[Dict[str, Any]]  # The 1-step-stale engine update.


class HybridTrainer:
    """Training steps over a dense module and an embedding engine.

    Args:
      model: Module with `forward(batch, activations)`; batches go to
        its parameters' device.
      engine: The `EmbeddingEngine` providing the activations.
      optimizer: A factory `parameters -> Optimizer` that `init` calls
        over the model's parameters (the JAX trainer's optax
        transformation, which `init` starts).
      pipelined: Apply the engine's update one step stale.
    """

    def __init__(
        self,
        model: nn.Module,
        engine: engine_lib.EmbeddingEngine,
        optimizer: OptimizerFactory,
        pipelined: bool = False,
    ) -> None:
        self.model = model
        self.engine = engine
        self.optimizer = optimizer
        self.pipelined = pipelined

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _features(self, batch) -> Dict[str, Any]:
        return {fc.name: batch[fc.name]
                for fc in self.engine.feature_configs}

    def init(self, generator: Optional[torch.Generator] = None,
             batch=None, *,
             engine_state: Optional[engine_lib.EngineState] = None,
             optimizer_state: Optional[Dict[str, Any]] = None
             ) -> HybridState:
        """Builds the optimizer over the model's parameters and the
        engine's state: fresh tables from `generator` (on the engine's
        device, or None), or `engine_state` as given. `optimizer_state`,
        a `state_dict` of such an optimizer, is loaded into it (a copy:
        the state's tensors are not shared). The model's parameters are
        used as they are. `batch`, if given, runs one forward pass
        without gradients as a check."""
        optimizer = self.optimizer(self.model.parameters())
        if optimizer_state is not None:
            optimizer.load_state_dict(copy.deepcopy(optimizer_state))
        if engine_state is None:
            engine_state = self.engine.init(generator)
        state = HybridState(params=dict(self.model.named_parameters()),
                            opt_state=optimizer,
                            engine_state=engine_state, pending=None)
        if batch is not None:
            self.eval_loss(state, batch)
        return state

    def train_step(self, state: HybridState,
                   batch) -> Tuple[HybridState, Tensor, Any]:
        """Runs one step; returns `(state, loss, aux)`. The tensors of
        `state` are updated in place; use the returned state."""
        batch = to_device(batch, self.device)[0]
        features = self._features(batch)
        engine_state = state.engine_state
        # Gathered copies from the tables before the pending update.
        acts = self.engine.lookup(engine_state, features)
        if state.pending is not None:
            engine_state = self.engine.update(
                engine_state, state.pending["features"],
                state.pending["grads"])
        leaves = {k: v.requires_grad_(True) for k, v in acts.items()}
        optimizer = state.opt_state
        optimizer.zero_grad(set_to_none=True)
        self.model.train()
        out = self.model(batch, leaves)
        loss, aux = out if isinstance(out, tuple) else (out, None)
        loss.backward()
        grads = {k: (torch.zeros_like(v) if v.grad is None else v.grad)
                 for k, v in leaves.items()}
        optimizer.step()
        pending = None
        if self.pipelined:
            pending = {"features": features, "grads": grads}
        else:
            engine_state = self.engine.update(engine_state, features, grads)
        return (dataclasses.replace(state, engine_state=engine_state,
                                    pending=pending),
                loss.detach(), aux)

    def finalize(self, state: HybridState) -> HybridState:
        """Applies the last pending engine update (pipelined mode)."""
        if state.pending is None:
            return state
        engine_state = self.engine.update(
            state.engine_state, state.pending["features"],
            state.pending["grads"])
        return dataclasses.replace(state, engine_state=engine_state,
                                   pending=None)

    @torch.no_grad()
    def eval_loss(self, state: HybridState, batch) -> Tuple[Tensor, Any]:
        """Forward-only `(loss, aux)` on the current state."""
        batch = to_device(batch, self.device)[0]
        acts = self.engine.lookup(state.engine_state, self._features(batch))
        self.model.eval()
        out = self.model(batch, acts)
        return out if isinstance(out, tuple) else (out, None)
