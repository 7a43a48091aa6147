"""Embedding lookups: the parts the engine uses.

Port of `recommenders_tpu/embedding/embedding.py:44-118`: `_pad_vocab`,
`combine` and `lookup_feature`. Feature semantics:

  - scalar ids `[B]` → `[B, dim]`;
  - multivalent ids `[B, L]` with `PAD_ID` padding → `[B, dim]` through
    the table's combiner (sum / mean / sqrtn), optionally weighted;
  - sequence features (`max_sequence_length > 0`) → `[B, L, dim]` with
    padding positions zeroed.

Negative ids gather row 0; only `PAD_ID` positions are zeroed, as in the
JAX package.

`TpuEmbedding` (`recommenders_tpu/embedding/embedding.py:121-203`) holds
its tables as `nn.Parameter`s, one per `TableConfig.name`, rows padded
to a multiple of 128, and looks features up through `lookup_feature`.
Its gradients are dense (the autograd of the gather), as under optax;
the sparse path is `engine.EmbeddingEngine`. With a `mesh` and
`shard_tables`, each table parameter holds this rank's rows of the table
(row-sharded over the table axis, as `nn.with_partitioning((MODEL_AXIS,
None))` shards it in JAX, `recommenders_tpu/embedding/embedding.py:177`)
and lookups go through `parallel.embedding_lookup.ShardedGather`.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from recommenders_tpu_torch.embedding import config as config_lib
from recommenders_tpu_torch.ops import sparse_apply
from recommenders_tpu_torch.parallel import embedding_lookup
from recommenders_tpu_torch.utils import collectives
from recommenders_tpu_torch.utils import device as device_lib

Tensor = torch.Tensor
FeatureInput = Union[Tensor, Tuple[Tensor, Tensor]]  # ids or (ids, weights)

PAD_ID = config_lib.PAD_ID

# Tables are padded to a row multiple (the JAX package's mesh divisor).
_ROW_MULTIPLE = 128


def _pad_vocab(vocabulary_size: int) -> int:
    return (
        (vocabulary_size + _ROW_MULTIPLE - 1) // _ROW_MULTIPLE
    ) * _ROW_MULTIPLE


def combine(
    embeddings: Tensor,
    ids: Tensor,
    combiner: str,
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Reduces `[B, L, dim]` lookups to `[B, dim]` with padding masked.

    sum = Σwᵢeᵢ, mean = Σwᵢeᵢ/Σwᵢ, sqrtn = Σwᵢeᵢ/√(Σwᵢ²).
    """
    valid = (ids != PAD_ID).to(embeddings.dtype)
    if weights is None:
        weights = valid
    else:
        weights = weights.to(embeddings.dtype) * valid
    weighted = embeddings * weights[..., None]
    # Summed in sequence order, from zero (XLA's CPU reduction order).
    total = torch.zeros_like(weighted[:, 0])
    for pos in range(weighted.shape[1]):
        total = total + weighted[:, pos]
    if combiner == "sum":
        return total
    if combiner == "mean":
        denom = torch.clamp(torch.sum(weights, dim=1), min=1e-12)
        return total / denom[:, None]
    if combiner == "sqrtn":
        denom = torch.clamp(
            torch.sqrt(torch.sum(torch.square(weights), dim=1)), min=1e-12
        )
        return total / denom[:, None]
    raise ValueError(f"Unknown combiner {combiner!r}")


class _GatherRows(torch.autograd.Function):
    """`table[rows]` whose backward sums duplicate rows' gradients in
    batch order (`sparse_apply.fixed_order_index_add_`), so two backward
    passes give the same bits. `index_select`'s own backward
    (`index_add_`) adds with atomics on the card, in arrival order."""

    @staticmethod
    def forward(ctx, table, rows):
        ctx.save_for_backward(rows)
        ctx.shape = table.shape
        return torch.index_select(table, 0, rows)

    @staticmethod
    def backward(ctx, grad):
        (rows,) = ctx.saved_tensors
        out = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
        return sparse_apply.fixed_order_index_add_(out, rows, grad), None


def gather_rows(table: Tensor, ids: Tensor) -> Tensor:
    """`table[max(ids, 0)]` as a new tensor (never a view), with
    `PAD_ID` positions zeroed. Differentiable in `table`, with
    duplicate ids' gradients summed in a fixed order."""
    rows = torch.clamp(ids.reshape(-1), min=0)
    if table.requires_grad and torch.is_grad_enabled():
        out = _GatherRows.apply(table, rows)
    else:
        out = torch.index_select(table, 0, rows)
    out = out.view(tuple(ids.shape) + (table.shape[1],))
    return out.masked_fill((ids == PAD_ID)[..., None], 0.0)


def lookup_feature(
    table: Tensor,
    feature_config: config_lib.FeatureConfig,
    feature: FeatureInput,
    gather: Callable[[Tensor, Tensor], Tensor] = None,
) -> Tensor:
    """Looks one feature up in a table. Returns a new tensor.

    `gather(table, ids)` reads the rows (default `gather_rows`; a
    sharded table passes its exchange)."""
    gather = gather or gather_rows
    if isinstance(feature, tuple):
        ids, weights = feature
    else:
        ids, weights = feature, None
    if ids.dim() == 1:
        return gather(table, ids)
    if ids.dim() != 2:
        raise ValueError(
            f"Feature {feature_config.name!r} ids must be rank 1 or 2, got "
            f"shape {tuple(ids.shape)}."
        )
    gathered = gather(table, ids)                       # [B, L, dim]
    if feature_config.max_sequence_length > 0:
        return gathered
    return combine(gathered, ids, feature_config.table.combiner, weights)


class TpuEmbedding(nn.Module):
    """An embedding collection as an `nn.Module`.

    Tables are parameters named after their `TableConfig.name` (so a
    table `user` is the parameter `user`), `[_pad_vocab(vocab), dim]`.
    Several features may share one table; two different configs under
    one name raise.

    ```python
    user_table = TableConfig(10_000, 64, name="user")
    movie_table = TableConfig(50_000, 64, name="movie")
    emb = TpuEmbedding((
        FeatureConfig(user_table, name="user_id"),
        FeatureConfig(movie_table, name="movie_id"),
        FeatureConfig(movie_table, name="watch_history",
                      max_sequence_length=10),
    ))
    activations = emb({"user_id": ids_b, "movie_id": ids_b,
                       "watch_history": ids_bl})
    ```

    Args:
      feature_configs: The feature declarations.
      shard_tables: Row-shard the tables over the mesh's table axis
        (with a `mesh`); without one every table is whole either way.
      dtype: Table dtype.
      device: Where the tables live (default CUDA).
      generator: Optional `torch.Generator` for the initial tables, drawn
        in table order by each table's initializer. With a mesh every
        rank draws the whole tables and keeps its rows, so the logical
        tables do not depend on the mesh.
      mesh: Optional `parallel.Mesh`.
      table_axis: The mesh axis the tables' rows are sharded over.
    """

    def __init__(
        self,
        feature_configs: Sequence[config_lib.FeatureConfig],
        shard_tables: bool = True,
        dtype: torch.dtype = torch.float32,
        device: device_lib.DeviceLike = "cuda",
        generator: Optional[torch.Generator] = None,
        mesh: Optional[collectives.Mesh] = None,
        table_axis: str = collectives.MODEL_AXIS,
    ) -> None:
        super().__init__()
        device = device_lib.resolve(device)
        self.feature_configs = tuple(feature_configs)
        self.shard_tables = shard_tables
        self.mesh = collectives.check_mesh(mesh, "TpuEmbedding")
        self.table_axis = table_axis
        shards = collectives.axis_size(mesh, table_axis) if shard_tables else 1
        self._sharded = shards > 1
        self._configs = {fc.name: fc for fc in self.feature_configs}
        for name, tc in self._tables().items():
            if not name.isidentifier():
                raise ValueError(
                    f"Table name {name!r} is not a valid parameter name.")
            init = tc.initializer or config_lib.default_initializer(tc.dim)
            table = init(generator, (_pad_vocab(tc.vocabulary_size), tc.dim),
                         dtype, device)
            if self._sharded:
                per = table.shape[0] // shards
                i = collectives.axis_index(mesh, table_axis)
                table = table[i * per:(i + 1) * per].clone()
            self.register_parameter(name, nn.Parameter(table))

    def _tables(self) -> Dict[str, config_lib.TableConfig]:
        tables: Dict[str, config_lib.TableConfig] = {}
        for fc in self.feature_configs:
            existing = tables.get(fc.table.name)
            if existing is not None and existing != fc.table:
                raise ValueError(
                    f"Two different TableConfigs share the name "
                    f"{fc.table.name!r}."
                )
            tables[fc.table.name] = fc.table
        return tables

    def forward(
        self, features: Mapping[str, FeatureInput]
    ) -> Dict[str, Tensor]:
        unknown = set(features) - set(self._configs)
        if unknown:
            raise ValueError(
                f"Features {sorted(unknown)} have no FeatureConfig. "
                f"Known: {sorted(self._configs)}."
            )
        gather = self._sharded_gather if self._sharded else None
        return {
            fname: lookup_feature(
                getattr(self, self._configs[fname].table.name),
                self._configs[fname], feature, gather=gather)
            for fname, feature in features.items()
        }

    def _sharded_gather(self, shard: Tensor, ids: Tensor) -> Tensor:
        return embedding_lookup.gather_rows(shard, ids, self.mesh,
                                            self.table_axis)

    def table_dict(self) -> Dict[str, Tensor]:
        """The table parameters by table name."""
        return {name: getattr(self, name) for name in self._tables()}
