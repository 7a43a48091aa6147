"""Mesh axes and the collectives over them, on `torch.distributed`.

The layer under `parallel/`: the ops, tasks, embeddings and models that
take a mesh import this module, and `parallel.mesh` (which builds
meshes) re-exports it, so nothing below `parallel/` imports that
package. The axis conventions are the JAX package's
(`recommenders_tpu/parallel/mesh.py`):

  - axis `"data"`: the batch dimension (data parallelism); gradients
    reduce over it;
  - axis `"model"`: embedding-table and corpus rows (model parallelism).

A `Mesh` names the dimensions of a
`torch.distributed.device_mesh.DeviceMesh` one to one with JAX's mesh
axes; `axis_index` is `jax.lax.axis_index`, and the collectives below
(`all_gather`, `all_reduce`, `broadcast`) are `lax.all_gather`,
`lax.psum` / `lax.pmax` and a replicated placement over one axis. They
run on every axis the mesh has, a one-rank axis included (where they
return their input's values); without a mesh, or for an axis the mesh
lacks, they return their input.

On a gloo group a CUDA tensor goes through host memory: it is copied to
the CPU, reduced there, and copied back (gloo runs few collectives on
CUDA tensors); bf16 (and bool) move as their bytes, and bf16 is summed
in f32 (a sum with zeros, the lookup's, stays exact). `STATS` counts the
collectives, their seconds on the host clock and the bytes staged
through the host.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Collective calls, their host seconds and the bytes staged through the
# host on gloo groups, since the last `reset_stats`.
STATS: Dict[str, float] = {"calls": 0, "seconds": 0.0, "staged_bytes": 0}


def reset_stats() -> None:
    STATS.update(calls=0, seconds=0.0, staged_bytes=0)


class Mesh:
    """Named axes over the ranks of the default process group
    (`parallel.create_mesh` builds one).

    Attributes:
      device_mesh: The `DeviceMesh`, one dimension per axis name.
      axis_names: The axis names, in mesh order.
      shape: `{axis: size}`, as `jax.sharding.Mesh.shape`.
      device_type: `"cuda"` or `"cpu"`.
    """

    def __init__(self, device_mesh, axis_names: Sequence[str]) -> None:
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.device_type = device_mesh.device_type

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device_type={self.device_type!r})"


def check_mesh(mesh: Any, owner: str) -> Optional[Mesh]:
    """`mesh` if it is None or a `Mesh`; raises TypeError otherwise."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"{owner}: the meshed path takes a "
            "recommenders_tpu_torch.parallel.Mesh (create_mesh), got "
            f"{type(mesh).__name__}."
        )
    return mesh


def axis_size(mesh: Optional[Mesh], axis: str) -> int:
    """The size of `axis` (1 without a mesh or for an absent axis)."""
    if mesh is None:
        return 1
    return mesh.shape.get(axis, 1)


def axis_index(mesh: Optional[Mesh], axis: str) -> int:
    """This rank's coordinate along `axis` (`jax.lax.axis_index`)."""
    if mesh is None or axis not in mesh.shape:
        return 0
    return mesh.device_mesh.get_local_rank(axis)


def _has_group(mesh: Optional[Mesh], axis: str) -> bool:
    return mesh is not None and axis in mesh.shape


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _timed(fn):
    start = time.perf_counter()
    out = fn()
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - start
    return out


def _on_host(x: Tensor, group) -> Tensor:
    """The tensor the collective runs on: a CPU copy on a gloo group."""
    if x.device.type != "cpu" and _staged(group):
        STATS["staged_bytes"] += x.numel() * x.element_size()
        return x.detach().to("cpu")
    return x.detach().contiguous()


# Dtypes gloo moves as they are; others move as their bytes.
_GLOO_DTYPES = (torch.float32, torch.float64, torch.float16, torch.int32,
                torch.int64, torch.int8, torch.uint8)


def _as_bits(x: Tensor, group) -> Tensor:
    """A tensor gloo can move holding `x`'s bits: other dtypes (bf16,
    bool, int16) as bytes along the last dimension (moved, never
    summed)."""
    if _staged(group) and x.dtype not in _GLOO_DTYPES:
        return x.reshape(x.shape or (1,)).view(torch.uint8)
    return x


def all_gather(x: Tensor, mesh: Optional[Mesh], axis: str,
               dim: int = 0) -> Tensor:
    """Concatenates every rank's `x` along `dim`, in axis order
    (`lax.all_gather(..., tiled=True)`). Every rank gets the result."""
    if not _has_group(mesh, axis):
        return x
    group = mesh.group(axis)

    def run():
        src = _as_bits(_on_host(x, group), group)
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).view(x.dtype).to(x.device)

    return _timed(run)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce(x: Tensor, mesh: Optional[Mesh], axis: str,
               op: str = "sum") -> Tensor:
    """A new tensor: `x` reduced over `axis` (`lax.psum` / `lax.pmax`)."""
    if not _has_group(mesh, axis):
        return x
    group = mesh.group(axis)

    def run():
        buf = _on_host(x, group).clone()
        if buf.dtype == torch.bfloat16 and _staged(group):
            buf = buf.float()
        dist.all_reduce(buf, op=_OPS[op], group=group)
        return buf.to(x.device, x.dtype)

    return _timed(run)


def broadcast(x: Tensor, mesh: Optional[Mesh], axis: str,
              src: int = 0) -> Tensor:
    """A new tensor: the `x` of the rank at coordinate `src` of `axis`."""
    if not _has_group(mesh, axis):
        return x
    group = mesh.group(axis)

    def run():
        buf = _as_bits(_on_host(x, group).clone(), group)
        dist.broadcast(buf, src=dist.get_global_rank(group, src),
                       group=group)
        return buf.view(x.dtype).reshape(x.shape).to(x.device)

    return _timed(run)


class _Gather(torch.autograd.Function):
    """`all_gather` along dim 0, differentiable. The backward is the
    all-gather's transpose, as JAX's: every rank's cotangent of the
    gathered rows is summed over the axis (each rank's rows are read by
    every rank's loss), and this rank keeps the rows of its own
    slice."""

    @staticmethod
    def forward(ctx, values, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.rows = values.shape[0]
        ctx.start = axis_index(mesh, axis) * values.shape[0]
        return all_gather(values, mesh, axis, dim=0)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce(grad.contiguous(), ctx.mesh, ctx.axis, op="sum")
        return total[ctx.start:ctx.start + ctx.rows], None, None


def gather(values: Tensor, mesh: Optional[Mesh], axis: str) -> Tensor:
    """Every rank's `values` concatenated along dim 0 in axis order, with
    gradients (the cotangents of a rank's rows summed over the axis)."""
    if not _has_group(mesh, axis):
        return values
    return _Gather.apply(values, mesh, axis)


def sum_grads(params, mesh: Optional[Mesh], axis: str) -> None:
    """Sums the parameters' gradients over `axis` in place, one
    collective per dtype. A parameter that has a gradient on any rank
    gets one on every rank (zeros where it had none), so every rank's
    optimizer steps the same parameters."""
    if not _has_group(mesh, axis):
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    has = torch.tensor([p.grad is not None for p in params],
                       dtype=torch.int32, device=params[0].device)
    has = all_reduce(has, mesh, axis) > 0
    live = [p for p, h in zip(params, has.tolist()) if h]
    by_dtype: Dict[torch.dtype, list] = {}
    for p in live:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for group in by_dtype.values():
        flat = all_reduce(torch.cat([p.grad.reshape(-1) for p in group]),
                          mesh, axis)
        offset = 0
        for p in group:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n


def batch_shardings(mesh: Optional[Mesh], data_axis: str = DATA_AXIS):
    """`leaf → placement` of a batch leaf: `data_axis` when its leading
    dimension divides over the axis (`shard_batch` splits it), else None
    (replicated), as `recommenders_tpu/parallel/mesh.py:56-73`."""
    size = axis_size(mesh, data_axis)

    def shard_leaf(leaf):
        shape = np.shape(leaf)
        return data_axis if len(shape) >= 1 and shape[0] % size == 0 else None

    return shard_leaf


def batch_shardable(batch: Any, mesh: Optional[Mesh],
                    data_axis: str = DATA_AXIS) -> bool:
    """Whether every leaf's leading dimension divides over the data
    axis (a ragged batch is replicated instead, as in `shard_batch`)."""
    shard_leaf = batch_shardings(mesh, data_axis)
    leaves = batch.values() if isinstance(batch, Mapping) else [batch]
    flat = []
    for leaf in leaves:
        flat.extend(leaf if isinstance(leaf, tuple) else [leaf])
    return all(shard_leaf(leaf) is not None for leaf in flat)


def shard_batch(batch: Any, mesh: Optional[Mesh],
                data_axis: str = DATA_AXIS) -> Any:
    """This rank's slice of a global batch along the data axis.

    Every leaf (a tensor or NumPy array, or a tuple of them, in a dict
    or alone) is split along its leading dimension into equal,
    contiguous slices, one per data-axis coordinate. A leaf whose
    leading dimension does not divide (a ragged final batch) is
    replicated whole, as `batch_shardings` does
    (`recommenders_tpu/parallel/mesh.py:56-73`).
    """
    size = axis_size(mesh, data_axis)
    if size == 1:
        return batch
    i = axis_index(mesh, data_axis)
    shard_leaf = batch_shardings(mesh, data_axis)

    def leaf(x):
        if isinstance(x, tuple):
            return tuple(leaf(v) for v in x)
        if shard_leaf(x) is None:
            return x
        rows = np.shape(x)[0] // size
        return x[i * rows:(i + 1) * rows]

    if isinstance(batch, Mapping):
        return {k: leaf(v) for k, v in batch.items()}
    return leaf(batch)
