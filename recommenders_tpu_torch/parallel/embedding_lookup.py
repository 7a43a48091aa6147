"""Explicit-collective sharded embedding lookup and update.

Port of `recommenders_tpu/parallel/embedding_lookup.py`. A table is
row-sharded over the table axis (each rank holds `[rows / S, dim]`, the
contiguous block `P(table_axis, None)` gives) and a batch is sharded
over the data axis:

  lookup:  every table shard sees the ids of its data slice (replicated
           over the table axis), gathers the rows it owns (other ids
           read zero), and a sum over the table axis assembles the full
           embeddings: one collective of `[batch, dim]`.
  update:  an all-gather over the data axis gives each table shard
           every (id, grad) pair, and each shard adds only the rows it
           owns, in a fixed order: one collective of `[batch, dim]`, no
           gradient reduction over the vocabulary.

Adding zeros is exact, so a lookup equals the unsharded gather bit for
bit. `ShardedGather` is the lookup as an autograd function: its
backward adds the output's cotangent into the rows this shard owns (the
cotangent is the same on every rank of the table axis, whose ranks all
compute the same loss), which is what a table sharded with
`nn.with_partitioning((MODEL_AXIS, None))` gets in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

from recommenders_tpu_torch.ops import sparse_apply
from recommenders_tpu_torch.parallel import mesh as mesh_lib

Tensor = torch.Tensor


def owned_rows(ids: Tensor, rows_per_shard: int, shard: int):
    """`(local rows, owned mask)`: ids rebased onto shard `shard`'s row
    range; an id outside it (another shard's, or negative padding) is
    not owned and its local row is clamped into range."""
    local = ids - shard * rows_per_shard
    owned = (local >= 0) & (local < rows_per_shard) & (ids >= 0)
    return torch.clamp(local, 0, rows_per_shard - 1), owned


def _owned_gather(table_shard: Tensor, ids: Tensor,
                  mesh: Optional[mesh_lib.Mesh], axis: str) -> Tensor:
    """Gathers the rows this shard owns; other shards' rows read zero."""
    safe, owned = owned_rows(ids, table_shard.shape[0],
                             mesh_lib.axis_index(mesh, axis))
    rows = table_shard[safe]
    return rows.masked_fill_(~owned[..., None], 0.0)


class ShardedGather(torch.autograd.Function):
    """`ids → [..., dim]` rows of a row-sharded table: owned rows, then a
    sum over the table axis. Backward: the cotangent added into the
    owned rows, in a fixed order."""

    @staticmethod
    def forward(ctx, table_shard, ids, mesh, axis):
        ctx.save_for_backward(ids)
        ctx.mesh, ctx.axis = mesh, axis
        ctx.shape = table_shard.shape
        rows = _owned_gather(table_shard, ids, mesh, axis)
        return mesh_lib.all_reduce(rows, mesh, axis, op="sum")

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        safe, owned = owned_rows(ids, ctx.shape[0],
                                 mesh_lib.axis_index(ctx.mesh, ctx.axis))
        out = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
        flat = grad.reshape(-1, ctx.shape[1])
        keep = owned.reshape(-1)
        sparse_apply.fixed_order_index_add_(out, safe.reshape(-1)[keep],
                                            flat[keep])
        return out, None, None, None


def gather_rows(table_shard: Tensor, ids: Tensor, mesh: mesh_lib.Mesh,
                axis: str) -> Tensor:
    """`embedding.gather_rows` over a row-sharded table: negative ids
    read row 0, `PAD_ID` (-1) reads zeros, and the table's gradient is
    `ShardedGather`'s."""
    rows = ShardedGather.apply(table_shard, torch.clamp(ids, min=0), mesh,
                               axis)
    return rows.masked_fill((ids == -1)[..., None], 0.0)


def sharded_lookup(
    table: Tensor,
    ids: Tensor,
    mesh: mesh_lib.Mesh,
    table_axis: str = mesh_lib.MODEL_AXIS,
    data_axis: str = mesh_lib.DATA_AXIS,
) -> Tensor:
    """`[b] ids → [b, dim]` rows from a row-sharded table.

    `table` is this rank's shard and `ids` its data slice; the result is
    its data slice of the embeddings. Negative ids (padding) return zero
    rows.
    """
    del data_axis  # The ids are this rank's data slice already.
    return ShardedGather.apply(table, ids, mesh, table_axis)


def sharded_scatter_add(
    table: Tensor,
    ids: Tensor,
    grads: Tensor,
    mesh: mesh_lib.Mesh,
    table_axis: str = mesh_lib.MODEL_AXIS,
    data_axis: str = mesh_lib.DATA_AXIS,
    scale: float = 1.0,
) -> Tensor:
    """Adds `scale · grads[i]` into row `ids[i]` of the sharded table
    (the SGD-flavored update; richer optimizers compose the same
    exchange with their slot math). Negative ids are dropped.

    `ids` / `grads` are this rank's data slice; they are gathered over
    the data axis, and this shard adds the rows it owns in the order of
    the global batch. Returns this rank's updated shard (a new tensor).
    """
    all_ids = mesh_lib.all_gather(ids, mesh, data_axis, dim=0)
    all_grads = mesh_lib.all_gather(grads, mesh, data_axis, dim=0)
    safe, owned = owned_rows(all_ids, table.shape[0],
                             mesh_lib.axis_index(mesh, table_axis))
    return sparse_apply.fixed_order_index_add_(
        table.clone(), safe[owned], scale * all_grads[owned])


def gspmd_lookup(
    table: Tensor,
    ids: Tensor,
    mesh: mesh_lib.Mesh,
    table_axis: str = mesh_lib.MODEL_AXIS,
    data_axis: str = mesh_lib.DATA_AXIS,
) -> Tensor:
    """The baseline the explicit exchange is held against: a plain
    gather on the whole table.

    In JAX this is a gather on sharded operands whose cross-shard routing
    the compiler (GSPMD) derives. torch has no such compiler, so here the
    table's shards are all-gathered over the table axis and the gather
    runs on the whole table. The result is the same as `sharded_lookup`'s
    (the rows are copied, never summed); the traffic is the table's, not
    the batch's.
    """
    del data_axis
    whole = mesh_lib.all_gather(table, mesh, table_axis, dim=0)
    rows = whole[torch.clamp(ids, min=0)]
    return rows.masked_fill_((ids < 0)[..., None], 0.0)
