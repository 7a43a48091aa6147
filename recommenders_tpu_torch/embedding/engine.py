"""Decoupled embedding engine: sparse lookups and updates outside autograd.

Port of `recommenders_tpu/embedding/engine.py`. Embedding tables are
not autograd parameters: the engine gathers activations, the caller
differentiates its loss with respect to the activations, and `update`
turns the activation gradients into per-row gradients and applies the
per-table sparse optimizer:

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

With `stack_tables=True`, tables that share a width and an optimizer
spec live as row ranges of one storage tensor, so `update` sorts their
ids together and K1 launches once for the whole group
(`recommenders_tpu/embedding/engine.py:236-301,847-919`).

With a `mesh` (`parallel.create_mesh`), every storage is row-sharded
over `table_axis`: this rank holds `[rows / S, dim]` of it, and every
rank calls the engine with the same arguments (SPMD). `row_sharding`
"div" gives rank r the contiguous rows `[r·R, (r+1)·R)`; "mod" gives it
the logical rows `{i : i % S == r}`, stored as a permutation
(`(i % S)·R + i // S`) of a contiguous block. A lookup gathers the rows
this shard owns and sums over the table axis (exactly the unsharded
gather). An update gathers the (id, grad) pairs over the data axis, so
every shard sees the global list, rebases it onto its row range (every
id outside `[0, R)` becomes padding) and runs K1 on its own shard: the
shard-local update of the reference's SparseCore engine
(`recommenders_tpu/embedding/engine.py:783-845`). The stochastic
rounding seed of rank r's shard is the unsharded seed plus `r·7919`.

Lane packing is a TPU layout; asking for it raises
`NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from recommenders_tpu_torch.embedding import config as config_lib
from recommenders_tpu_torch.embedding import embedding as embedding_lib
from recommenders_tpu_torch.embedding import sparse_optimizer
from recommenders_tpu_torch.parallel import embedding_lookup
from recommenders_tpu_torch.utils import collectives
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
      mesh: Optional `parallel.Mesh`; storages are row-sharded over its
        `table_axis`, and the update gathers (id, grad) pairs over its
        `data_axis` (if it has one).
      dtype: Table dtype (f32 or bf16).
      row_sharding: "div" or "mod"; without a mesh both are the identity.
      sparse_update_kernel: None or True takes the kernel path (K1 for
        CUDA tables, its twin for CPU tables) for the kinds it supports;
        False takes the scatter path.
      slot_dtype: Optimizer-slot dtype; None means f32.
      stochastic_rounding: Round bf16 state writes stochastically on the
        kernel path, seeded per (step, storage).
      stack_tables: Store the tables that share (dim, optimizer spec) as
        row ranges of one storage tensor named `"stacked:" +
        "+".join(members)`, members in declaration order, each at the
        sum of the padded rows before it. Tables with `max_unique_ids`
        stay solo (the bound is per table). Needs `row_sharding="div"`.
        Storage is not padded past its members: K1 walks the runs of the
        sorted ids, not row blocks, so the row count sets no block size
        (the JAX engine pads to a 2048-row multiple for its TPU block
        picker). `logical_state` / `state_from_logical` move state
        between the stacked and unstacked layouts, slots included.
      exact_grad_routing: Accepted; duplicate sums are always exact f32.
      lane_pack: Must be None or False (lane packing is a TPU layout).
      device: Where the state lives (default CUDA).
      table_axis: The mesh axis sharding table rows.
      data_axis: The mesh axis the batch is sharded over.
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
        table_axis: str = collectives.MODEL_AXIS,
        data_axis: str = collectives.DATA_AXIS,
    ) -> None:
        if row_sharding not in ("div", "mod"):
            raise ValueError(
                f"row_sharding must be 'div' or 'mod', got {row_sharding!r}"
            )
        self.mesh = collectives.check_mesh(mesh, "EmbeddingEngine")
        self.table_axis = table_axis
        self.data_axis = data_axis
        if stack_tables and row_sharding == "mod":
            raise ValueError(
                "stack_tables requires row_sharding='div' (the mod "
                "permutation is per-table)."
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
        self.stack_tables = stack_tables
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

        # Storage map. _storage: table name -> (storage name, row offset);
        # _storage_members: storage name -> member tables in offset order.
        # Both follow declaration order, as `init` draws in it.
        self._storage: Dict[str, Tuple[str, int]] = {}
        self._storage_members: Dict[str, List[str]] = {}
        self._storage_rows: Dict[str, int] = {}
        groups: Dict = {}
        for name, tc in self._tables.items():
            solo = not stack_tables or tc.max_unique_ids is not None
            key = ("solo", name) if solo else ("stack", tc.dim,
                                                self._spec(tc))
            groups.setdefault(key, []).append(name)
        for members in groups.values():
            sname = (members[0] if len(members) == 1
                     else "stacked:" + "+".join(members))
            offset = 0
            for name in members:
                self._storage[name] = (sname, offset)
                offset += self._padded_rows(self._tables[name])
            self._storage_members[sname] = members
            self._storage_rows[sname] = offset
            if offset % self._num_shards():
                raise ValueError(
                    f"storage {sname!r}: {offset} rows do not divide over "
                    f"the {self._num_shards()}-way {table_axis!r} axis."
                )

    def _spec(self, tc: config_lib.TableConfig) -> config_lib.OptimizerSpec:
        return tc.optimizer or self.default_optimizer

    def _padded_rows(self, tc: config_lib.TableConfig) -> int:
        return embedding_lib._pad_vocab(tc.vocabulary_size)

    def _num_shards(self) -> int:
        return collectives.axis_size(self.mesh, self.table_axis)

    def _shard(self) -> int:
        return collectives.axis_index(self.mesh, self.table_axis)

    def _sharded(self) -> bool:
        return self._num_shards() > 1

    def _mod(self) -> bool:
        return self.row_sharding == "mod" and self._sharded()

    def _local_rows(self, rows: int) -> slice:
        """This shard's block of a storage's `rows` physical rows."""
        per = rows // self._num_shards()
        return slice(self._shard() * per, (self._shard() + 1) * per)

    def _permute(self, logical: Tensor, tc: config_lib.TableConfig) -> Tensor:
        """Logical rows → the physical (mod-permuted) row order."""
        if not self._mod():
            return logical
        s = self._num_shards()
        p = torch.arange(logical.shape[0], device=logical.device)
        per = logical.shape[0] // s
        return logical[(p % per) * s + p // per]

    def _unpermute(self, physical: Tensor,
                   tc: config_lib.TableConfig) -> Tensor:
        if not self._mod():
            return physical
        ids = torch.arange(physical.shape[0], device=physical.device)
        return physical[self._to_physical(ids, tc)]

    # --- State ------------------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None) -> EngineState:
        """Initializes tables (in declaration order) and slots.

        The draws come from `generator`, which must live on the engine's
        device (or be None); they never equal the JAX engine's. Under a
        mesh every rank draws the whole tables from the same generator
        state and keeps its own shard, so the logical tables do not
        depend on the mesh.
        """
        drawn = {}
        for name, tc in self._tables.items():
            init = tc.initializer or config_lib.default_initializer(tc.dim)
            drawn[name] = self._permute(
                init(generator, (self._padded_rows(tc), tc.dim),
                     self.dtype, self.device).to(self.dtype), tc)
        tables, slots = {}, {}
        for sname, members in self._storage_members.items():
            storage = torch.cat([drawn.pop(m) for m in members])
            tables[sname] = storage[
                self._local_rows(storage.shape[0])].contiguous()
            slots[sname] = sparse_optimizer.init_slots(
                self._spec(self._tables[members[0]]), tables[sname],
                self.slot_dtype,
            )
        return EngineState(tables=tables, slots=slots, step=0)

    def _member_rows(self, plane: Tensor, name: str) -> Tensor:
        """Table `name`'s rows of a storage plane (a view)."""
        sname, offset = self._storage[name]
        if sname == name:
            return plane
        return plane[offset:offset + self._padded_rows(self._tables[name])]

    def _whole(self, plane: Tensor) -> Tensor:
        """A storage plane with every shard's rows (a collective over the
        table axis when sharded; the plane itself otherwise)."""
        if not self._sharded():
            return plane
        return collectives.all_gather(plane, self.mesh, self.table_axis, dim=0)

    def _logical_rows(self, plane: Tensor, name: str) -> Tensor:
        """Table `name`'s rows of a whole storage plane, in logical
        order."""
        return self._unpermute(self._member_rows(plane, name),
                               self._tables[name])

    def logical_tables(self, state: EngineState) -> Dict[str, Tensor]:
        """Tables with rows in logical id order: the storage itself for
        a solo table, a view of its row range for a stacked one. Under
        a mesh the shards are gathered first (a collective: every rank
        calls it) and mod-sharded rows are put back in logical order."""
        whole = {sname: self._whole(t) for sname, t in state.tables.items()}
        return {name: self._logical_rows(whole[self._storage[name][0]], name)
                for name in self._tables}

    def logical_state(self, state: EngineState) -> Dict:
        """`{"tables": {name: [V, d]}, "slots": {name: {slot: plane}},
        "step": step}`: the JAX engine's layout-free form. Row planes of
        a stacked storage come back as views of each member's rows; a
        slot that is not a row plane (clippy's scalar clipping factor)
        is shared by every member. Under a mesh it is a collective and
        every rank gets the whole state."""
        slots: Dict[str, Dict[str, Tensor]] = {}
        for sname, members in self._storage_members.items():
            rows = state.tables[sname].shape[0]
            planes = {k: (self._whole(v) if v.dim() == 2
                          and v.shape[0] == rows else v)
                      for k, v in state.slots[sname].items()}
            for name in members:
                slots[name] = {
                    k: (self._logical_rows(planes[k], name)
                        if v.dim() == 2 and v.shape[0] == rows else v)
                    for k, v in state.slots[sname].items()
                }
        return {"tables": self.logical_tables(state), "slots": slots,
                "step": state.step}

    def state_from_logical(self, logical: Mapping) -> EngineState:
        """This engine's `EngineState` from `logical_state` output (of
        this engine, or of one with another stacking layout or mesh),
        moved to the engine's device and cast to its table and slot
        dtypes; under a mesh, this rank keeps its own shard. Table names
        and shapes must match."""
        slot_dtype = self.slot_dtype or torch.float32
        for name, tc in self._tables.items():
            table = logical["tables"][name]
            want = (self._padded_rows(tc), tc.dim)
            if tuple(table.shape) != want:
                raise ValueError(
                    f"table {name!r}: shape {tuple(table.shape)}, the "
                    f"engine stores {want}"
                )
        tables, slots = {}, {}
        for sname, members in self._storage_members.items():
            own = self._local_rows(self._storage_rows[sname])

            def storage(planes, dtype, own=own, members=members):
                whole = torch.cat([
                    self._permute(p.to(self.device), self._tables[m])
                    for p, m in zip(planes, members)])
                return whole[own].to(dtype).contiguous()

            tables[sname] = storage(
                [logical["tables"][m] for m in members], self.dtype)
            slots[sname] = {}
            for k, v in logical["slots"][members[0]].items():
                if v.dim() == 2 and v.shape[0] == self._padded_rows(
                        self._tables[members[0]]):
                    slots[sname][k] = storage(
                        [logical["slots"][m][k] for m in members],
                        slot_dtype)
                else:
                    slots[sname][k] = v.to(self.device,
                                           slot_dtype).contiguous()
        return EngineState(tables=tables, slots=slots,
                           step=int(logical["step"]))

    def _to_physical(self, ids: Tensor, tc: config_lib.TableConfig) -> Tensor:
        """Logical ids → rows of the table's storage: the identity for a
        solo table (or, sharded "mod", the permutation `(i % S)·R +
        i // S`); a stacked member's ids move by its row offset.
        Negative ids (`PAD_ID`) pass through. An id past the member's
        rows maps to the storage's row count, outside every member, so
        `update` drops it and `lookup` refuses it, as for a solo table
        (the JAX engine would land it in the next member)."""
        if self._mod():
            s = self._num_shards()
            per = self._padded_rows(tc) // s
            phys = torch.where(ids >= self._padded_rows(tc),
                               self._padded_rows(tc),
                               (ids % s) * per + torch.div(
                                   ids, s, rounding_mode="floor"))
            return torch.where(ids < 0, ids, phys)
        sname, offset = self._storage[tc.name]
        if sname == tc.name:
            return ids
        beyond = torch.where(ids >= self._padded_rows(tc),
                             self._storage_rows[sname], ids + offset)
        return torch.where(ids < 0, ids, beyond)

    def _physical_feature(
        self, fc: config_lib.FeatureConfig, feature: FeatureInput
    ) -> FeatureInput:
        ids, weights = _split_feature(feature)
        ids = self._to_physical(ids, fc.table)
        return ids if weights is None else (ids, weights)

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
                sname, _ = self._storage[fc.table.name]
                out[fname] = embedding_lib.lookup_feature(
                    state.tables[sname], fc,
                    self._physical_feature(fc, feature),
                    gather=self._sharded_gather if self._sharded() else None,
                )
        return out

    def _sharded_gather(self, shard: Tensor, ids: Tensor) -> Tensor:
        return embedding_lookup.gather_rows(shard, ids, self.mesh,
                                            self.table_axis)

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

    def _storage_grads(
        self,
        features: Mapping[str, FeatureInput],
        activation_grads: Mapping[str, Tensor],
    ) -> Dict[str, Tuple[Tensor, Tensor]]:
        """Storage name → the (ids, row grads) of every feature it holds,
        concatenated in feature order, in the storage's rows."""
        ids_of: Dict[str, list] = {}
        grads_of: Dict[str, list] = {}
        for fname, grad in activation_grads.items():
            fc = self._configs[fname]
            ids, grads = self._row_grads(
                fc, self._physical_feature(fc, features[fname]), grad)
            sname, _ = self._storage[fc.table.name]
            ids_of.setdefault(sname, []).append(ids)
            grads_of.setdefault(sname, []).append(grads)
        return {name: (torch.cat(ids_of[name]), torch.cat(grads_of[name]))
                for name in ids_of}

    def update(
        self,
        state: EngineState,
        features: Mapping[str, FeatureInput],
        activation_grads: Mapping[str, Tensor],
    ) -> EngineState:
        """Applies one sparse-optimizer step from activation gradients.

        Gradients of features sharing a storage (a table, or a stacked
        group of tables) are concatenated in their storage's rows, so
        each storage sees one update a step: one K1 launch for a whole
        stacked group. The stochastic-rounding seed of a storage is
        `step · 1000003 + t_idx` in int32 arithmetic, `t_idx` its index
        among the updated storage names in sorted order; so bf16 state
        with stochastic rounding differs between the stacked and the
        unstacked layouts, and f32 state (or rounding off) does not. The
        tensors of `state` are updated in place; use the returned state.

        Under a mesh, `features` and `activation_grads` are this rank's
        data slice. Each storage's pairs are gathered over the data axis
        (in rank order, so the global list is the global batch's), a
        `max_unique_ids` table folds the global list, and each shard
        runs K1 on its own rows with seed `+ shard · 7919`.
        """
        use_kernel = self.sparse_update_kernel
        if use_kernel is None:
            use_kernel = True
        tables = dict(state.tables)
        slots = dict(state.slots)
        for t_idx, (name, (ids, grads)) in enumerate(
            sorted(self._storage_grads(features, activation_grads).items())
        ):
            members = self._storage_members[name]
            tc = self._tables[members[0]]
            ids = ids.to(tables[name].device)
            grads = grads.to(tables[name].device)
            sr_seed = None
            if self.stochastic_rounding:
                sr_seed = _wrap_int32(state.step * 1000003 + t_idx)
            # A stacked group never holds a max_unique_ids table.
            max_unique = tc.max_unique_ids
            if self.mesh is not None:
                ids, grads, max_unique = self._shard_pairs(
                    ids, grads, max_unique, tables[name].shape[0])
                if sr_seed is not None:
                    sr_seed = _wrap_int32(sr_seed + self._shard() * 7919)
            tables[name], slots[name] = sparse_optimizer.apply_sparse(
                self._spec(tc), tables[name], slots[name], ids, grads,
                state.step,
                max_unique=max_unique,
                use_kernel=use_kernel,
                sr_seed=sr_seed,
                exact_routing=self.exact_grad_routing,
            )
        return EngineState(tables=tables, slots=slots, step=state.step + 1)

    def _shard_pairs(self, ids: Tensor, grads: Tensor,
                     max_unique: Optional[int], rows: int):
        """`(ids, grads, max_unique)` for this shard's update: the pairs
        of the whole data axis, folded first for a `max_unique_ids`
        table (globally, as the unsharded engine folds, so the same ids
        survive a step that exceeds the bound), then rebased onto this
        shard's rows with every id outside them made padding, so a
        foreign id never reaches K1 or takes a fold slot."""
        ids = collectives.all_gather(ids, self.mesh, self.data_axis)
        grads = collectives.all_gather(grads, self.mesh, self.data_axis)
        if max_unique is not None and max_unique < ids.shape[0]:
            ids, grads = sparse_optimizer.dedupe_sum(ids, grads, max_unique)
        if self._sharded():
            local, owned = embedding_lookup.owned_rows(
                ids, rows, self._shard())
            ids = torch.where(owned, local, PAD_ID)
        return ids, grads, None

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
