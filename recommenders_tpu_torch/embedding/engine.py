"""Decoupled embedding engine: sparse lookups and updates outside autograd.

Port of `recommenders_tpu/embedding/engine.py`, unsharded, with
`row_sharding="div"`. Embedding tables are not autograd parameters: the
engine gathers activations, the caller differentiates its loss with
respect to the activations, and `update` turns the activation gradients
into per-row gradients and applies the per-table sparse optimizer:

    engine = EmbeddingEngine(feature_configs, device="cuda")
    state = engine.init(torch.Generator().manual_seed(0))
    acts = engine.lookup(state, features)          # gathered copies
    ...                                            # loss, autograd
    state = engine.update(state, features, act_grads)

By default (`sparse_update_kernel=None`) the update takes the kernel
path of `sparse_optimizer.apply_sparse`, which launches the CUDA kernel
K1 for CUDA tables and runs its plain twin for CPU tables, so both give
the same numbers (and the same stochastic-rounding bits).

Unlike the JAX engine, which is functional, `update` changes the table
and slot tensors IN PLACE and returns a new `EngineState` holding them
with the step advanced; do not reuse the state passed in. `lookup`
returns gathered copies, so activations held across an update (the
pipelined step) keep the values they were read with.

Lane packing is a TPU layout; table stacking and the meshed engine come
in a later slice. Asking for any of them raises `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from recommenders_tpu_torch.embedding import config as config_lib
from recommenders_tpu_torch.embedding import embedding as embedding_lib
from recommenders_tpu_torch.embedding import sparse_optimizer
from recommenders_tpu_torch.utils import device as device_lib

Tensor = torch.Tensor
FeatureInput = embedding_lib.FeatureInput

PAD_ID = config_lib.PAD_ID


@dataclasses.dataclass
class EngineState:
    """All engine state: tables, optimizer slots and the step counter."""

    tables: Dict[str, Tensor]
    slots: Dict[str, Dict[str, Tensor]]
    step: int


def _split_feature(feature: FeatureInput) -> Tuple[Tensor, Optional[Tensor]]:
    if isinstance(feature, tuple):
        return feature
    return feature, None


def _wrap_int32(x: int) -> int:
    """`x` in int32 wrap-around arithmetic."""
    return (x + 2**31) % 2**32 - 2**31


class EmbeddingEngine:
    """Embedding tables with decoupled sparse optimization.

    Args:
      feature_configs: Feature declarations (tables may be shared).
      optimizer: Default `OptimizerSpec` for tables that set none.
      mesh: Must be None (the meshed engine comes in a later slice).
      dtype: Table dtype (f32 or bf16).
      row_sharding: "div" or "mod"; without a mesh both are the identity.
      sparse_update_kernel: None or True takes the kernel path (K1 for
        CUDA tables, its twin for CPU tables) for the kinds it supports;
        False takes the scatter path.
      slot_dtype: Optimizer-slot dtype; None means f32.
      stochastic_rounding: Round bf16 state writes stochastically on the
        kernel path, seeded per (step, table).
      stack_tables: Must be False (stacking comes in a later slice).
      exact_grad_routing: Accepted; duplicate sums are always exact f32.
      lane_pack: Must be None or False (lane packing is a TPU layout).
      device: Where the state lives (default CUDA).
    """

    def __init__(
        self,
        feature_configs,
        optimizer: Optional[config_lib.OptimizerSpec] = None,
        mesh=None,
        dtype: torch.dtype = torch.float32,
        row_sharding: str = "div",
        sparse_update_kernel: Optional[bool] = None,
        slot_dtype: Optional[torch.dtype] = None,
        stochastic_rounding: bool = True,
        stack_tables: bool = False,
        exact_grad_routing: bool = True,
        lane_pack: Optional[bool] = None,
        device="cuda",
    ) -> None:
        if row_sharding not in ("div", "mod"):
            raise ValueError(
                f"row_sharding must be 'div' or 'mod', got {row_sharding!r}"
            )
        if mesh is not None:
            raise NotImplementedError(
                "The meshed engine is not ported yet (ROADMAP.md Queue A)."
            )
        if stack_tables:
            raise NotImplementedError(
                "stack_tables is not ported yet (ROADMAP.md Queue A)."
            )
        if lane_pack:
            raise NotImplementedError(
                "lane_pack is a TPU storage layout; the port stores every "
                "table unpacked (ROADMAP.md Queue A)."
            )
        self.feature_configs = tuple(feature_configs)
        self.default_optimizer = optimizer or config_lib.OptimizerSpec()
        self.dtype = dtype
        self.row_sharding = row_sharding
        self.sparse_update_kernel = sparse_update_kernel
        self.slot_dtype = slot_dtype
        self.stochastic_rounding = stochastic_rounding
        self.exact_grad_routing = exact_grad_routing
        self.device = device_lib.resolve(device)

        self._tables: Dict[str, config_lib.TableConfig] = {}
        for fc in self.feature_configs:
            existing = self._tables.get(fc.table.name)
            if existing is not None and existing != fc.table:
                raise ValueError(
                    f"Two different TableConfigs share the name "
                    f"{fc.table.name!r}."
                )
            self._tables[fc.table.name] = fc.table
        self._configs = {fc.name: fc for fc in self.feature_configs}

    def _spec(self, tc: config_lib.TableConfig) -> config_lib.OptimizerSpec:
        return tc.optimizer or self.default_optimizer

    def _padded_rows(self, tc: config_lib.TableConfig) -> int:
        return embedding_lib._pad_vocab(tc.vocabulary_size)

    # --- State ------------------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None) -> EngineState:
        """Initializes tables (in declaration order) and slots.

        The draws come from `generator`, which must live on the engine's
        device (or be None); they never equal the JAX engine's.
        """
        tables, slots = {}, {}
        for name, tc in self._tables.items():
            init = tc.initializer or config_lib.default_initializer(tc.dim)
            table = init(generator, (self._padded_rows(tc), tc.dim),
                         self.dtype, self.device)
            tables[name] = table.to(self.dtype).contiguous()
            slots[name] = sparse_optimizer.init_slots(
                self._spec(tc), tables[name], self.slot_dtype
            )
        return EngineState(tables=tables, slots=slots, step=0)

    def logical_tables(self, state: EngineState) -> Dict[str, Tensor]:
        """Tables with rows in logical id order (the stored layout)."""
        return {name: state.tables[name] for name in self._tables}

    def logical_state(self, state: EngineState) -> Dict:
        """`{"tables": {name: [V, d]}, "slots": {name: {slot: plane}},
        "step": step}`: the JAX engine's layout-free form."""
        return {
            "tables": self.logical_tables(state),
            "slots": {name: dict(state.slots[name]) for name in self._tables},
            "step": state.step,
        }

    def state_from_logical(self, logical: Mapping) -> EngineState:
        """This engine's `EngineState` from `logical_state` output, moved
        to the engine's device and cast to its table and slot dtypes
        (a no-op for state it wrote itself). Table names and shapes must
        match."""
        slot_dtype = self.slot_dtype or torch.float32
        tables, slots = {}, {}
        for name, tc in self._tables.items():
            table = logical["tables"][name]
            want = (self._padded_rows(tc), tc.dim)
            if tuple(table.shape) != want:
                raise ValueError(
                    f"table {name!r}: shape {tuple(table.shape)}, the "
                    f"engine stores {want}"
                )
            tables[name] = table.to(self.device, self.dtype).contiguous()
            slots[name] = {
                k: v.to(self.device, slot_dtype).contiguous()
                for k, v in logical["slots"][name].items()
            }
        return EngineState(tables=tables, slots=slots,
                           step=int(logical["step"]))

    # --- Forward ----------------------------------------------------------

    def lookup(
        self, state: EngineState, features: Mapping[str, FeatureInput]
    ) -> Dict[str, Tensor]:
        """Gather + combine activations for each feature.

        Returns new tensors (gathered copies, never views of a table).
        Differentiate the result, not this function.
        """
        unknown = set(features) - set(self._configs)
        if unknown:
            raise ValueError(
                f"Features {sorted(unknown)} have no FeatureConfig. "
                f"Known: {sorted(self._configs)}."
            )
        out = {}
        with torch.no_grad():
            for fname, feature in features.items():
                fc = self._configs[fname]
                out[fname] = embedding_lib.lookup_feature(
                    state.tables[fc.table.name], fc, feature
                )
        return out

    # --- Backward ---------------------------------------------------------

    def _row_grads(
        self,
        fc: config_lib.FeatureConfig,
        feature: FeatureInput,
        act_grad: Tensor,
    ) -> Tuple[Tensor, Tensor]:
        """Inverts the combiner: activation grads → flat (ids, row grads),
        in the activation grads' dtype."""
        ids, weights = _split_feature(feature)
        zero = torch.zeros((), dtype=act_grad.dtype, device=act_grad.device)
        if ids.dim() == 1:
            return ids, torch.where((ids != PAD_ID)[:, None], act_grad, zero)
        valid = (ids != PAD_ID).to(act_grad.dtype)
        if fc.max_sequence_length > 0:
            grads = act_grad * valid[..., None]
            return ids.reshape(-1), grads.reshape(-1, act_grad.shape[-1])
        w = valid if weights is None else weights.to(act_grad.dtype) * valid
        combiner = fc.table.combiner
        if combiner == "sum":
            scale = w
        elif combiner == "mean":
            denom = torch.clamp(torch.sum(w, dim=1), min=1e-12)
            scale = w / denom[:, None]
        elif combiner == "sqrtn":
            denom = torch.clamp(
                torch.sqrt(torch.sum(torch.square(w), dim=1)), min=1e-12
            )
            scale = w / denom[:, None]
        else:
            raise ValueError(f"Unknown combiner {combiner!r}")
        grads = scale[..., None] * act_grad[:, None, :]
        return ids.reshape(-1), grads.reshape(-1, act_grad.shape[-1])

    def update(
        self,
        state: EngineState,
        features: Mapping[str, FeatureInput],
        activation_grads: Mapping[str, Tensor],
    ) -> EngineState:
        """Applies one sparse-optimizer step from activation gradients.

        Gradients of features sharing a table are concatenated, so each
        table sees one update a step. The stochastic-rounding seed of a
        table is `step · 1000003 + t_idx` in int32 arithmetic, `t_idx`
        its index among the updated table names in sorted order. The
        tensors of `state` are updated in place; use the returned state.
        """
        per_table_ids: Dict[str, list] = {}
        per_table_grads: Dict[str, list] = {}
        for fname, grad in activation_grads.items():
            fc = self._configs[fname]
            ids, grads = self._row_grads(fc, features[fname], grad)
            per_table_ids.setdefault(fc.table.name, []).append(ids)
            per_table_grads.setdefault(fc.table.name, []).append(grads)

        use_kernel = self.sparse_update_kernel
        if use_kernel is None:
            use_kernel = True
        tables = dict(state.tables)
        slots = dict(state.slots)
        for t_idx, (name, ids_list) in enumerate(
            sorted(per_table_ids.items())
        ):
            tc = self._tables[name]
            ids = torch.cat(ids_list).to(tables[name].device)
            grads = torch.cat(per_table_grads[name]).to(tables[name].device)
            sr_seed = None
            if self.stochastic_rounding:
                sr_seed = _wrap_int32(state.step * 1000003 + t_idx)
            tables[name], slots[name] = sparse_optimizer.apply_sparse(
                self._spec(tc), tables[name], slots[name], ids, grads,
                state.step,
                max_unique=tc.max_unique_ids,
                use_kernel=use_kernel,
                sr_seed=sr_seed,
                exact_routing=self.exact_grad_routing,
            )
        return EngineState(tables=tables, slots=slots, step=state.step + 1)

    # --- Steps --------------------------------------------------------------

    @staticmethod
    def _value_and_grad(
        loss_of_activations: Callable, acts: Dict[str, Tensor]
    ):
        """`(loss, aux, grads)`: the loss of the activations and its
        gradients with respect to them (zeros for unused ones), each in
        its activation's dtype."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in acts.items()}
        out = loss_of_activations(leaves)
        loss, aux = out if isinstance(out, tuple) else (out, None)
        names = list(leaves)
        got = torch.autograd.grad(
            loss, [leaves[k] for k in names], allow_unused=True
        )
        grads = {
            k: (torch.zeros_like(leaves[k]) if g is None else g)
            for k, g in zip(names, got)
        }
        return loss.detach(), aux, grads

    def pipelined_grad_and_update(
        self,
        state: EngineState,
        pending,
        features: Mapping[str, FeatureInput],
        loss_of_activations: Callable,
    ):
        """One 1-step-stale step: this step's lookup reads the tables
        before the previous step's pending update is applied.

        Args:
          state: Engine state (updated in place).
          pending: None on the first step, else the pending update the
            previous call returned.
          features: This step's id features.
          loss_of_activations: `acts -> loss` (or `(loss, aux)`).

        Returns:
          `(new_state, new_pending, loss, aux)`. Call `flush` on the last
          pending update after the final step.
        """
        acts = self.lookup(state, features)
        loss, aux, grads = self._value_and_grad(loss_of_activations, acts)
        if pending is not None:
            state = self.update(state, pending["features"], pending["grads"])
        return state, {"features": features, "grads": grads}, loss, aux

    def flush(self, state: EngineState, pending) -> EngineState:
        """Applies the final pending update after the last pipelined step."""
        if pending is None:
            return state
        return self.update(state, pending["features"], pending["grads"])

    def grad_and_update(
        self,
        state: EngineState,
        features: Mapping[str, FeatureInput],
        loss_of_activations: Callable,
    ):
        """One step for losses that are functions of activations only.

        Returns `(new_state, loss, aux)`.
        """
        acts = self.lookup(state, features)
        loss, aux, grads = self._value_and_grad(loss_of_activations, acts)
        return self.update(state, features, grads), loss, aux
