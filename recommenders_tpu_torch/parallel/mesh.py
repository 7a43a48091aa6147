"""Device meshes over `torch.distributed`: axis conventions, batch
sharding and the collectives the sharded paths use.

Port of `recommenders_tpu/parallel/mesh.py`. The framework's SPMD
convention is the JAX package's:

  - axis `"data"`: the batch dimension (data parallelism); gradients
    reduce over it;
  - axis `"model"`: embedding-table and corpus rows (model parallelism).

JAX runs one program over many devices; torch runs one process per rank
(`parallel.launch.run_ranks`, or any launcher that initializes the
default process group), and every rank calls the same entry points with
the same arguments. This module builds meshes (`create_mesh`,
`local_data_parallel_mesh`) and places tensors (`replicated`); the axis
names, `Mesh`, `axis_index`, `shard_batch` and the collectives
(`all_gather`, `all_reduce`, `broadcast`, `gather`, `sum_grads`) live in
`utils/collectives.py`, which the layers under `parallel/` import, and
are re-exported here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from recommenders_tpu_torch.utils import device as device_lib
from recommenders_tpu_torch.utils.collectives import DATA_AXIS
from recommenders_tpu_torch.utils.collectives import MODEL_AXIS
from recommenders_tpu_torch.utils.collectives import STATS
from recommenders_tpu_torch.utils.collectives import Mesh
from recommenders_tpu_torch.utils.collectives import Tensor
from recommenders_tpu_torch.utils.collectives import all_gather
from recommenders_tpu_torch.utils.collectives import all_reduce
from recommenders_tpu_torch.utils.collectives import axis_index
from recommenders_tpu_torch.utils.collectives import axis_size
from recommenders_tpu_torch.utils.collectives import batch_shardable
from recommenders_tpu_torch.utils.collectives import batch_shardings
from recommenders_tpu_torch.utils.collectives import broadcast
from recommenders_tpu_torch.utils.collectives import check_mesh
from recommenders_tpu_torch.utils.collectives import gather
from recommenders_tpu_torch.utils.collectives import reset_stats
from recommenders_tpu_torch.utils.collectives import shard_batch
from recommenders_tpu_torch.utils.collectives import sum_grads

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "STATS", "Mesh", "all_gather", "all_reduce",
    "axis_index", "axis_size", "batch_shardable", "batch_shardings",
    "broadcast", "check_mesh", "create_mesh", "gather",
    "local_data_parallel_mesh", "replicated", "reset_stats", "shard_batch",
    "sum_grads",
]


def create_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
    device_type: str = "cuda",
) -> Mesh:
    """A mesh over every rank of the default process group.

    Args:
      shape: Mesh shape; defaults to all ranks on the first axis
        (`(world, 1)` for the default two axes).
      axis_names: Mesh axis names.
      device_type: `"cuda"` (the default; raises without CUDA) or
        `"cpu"`.

    Returns:
      A `Mesh`. The default process group must be initialized (see
      `parallel.launch.run_ranks`).
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs an initialized default process group "
            "(parallel.launch.run_ranks, or "
            "torch.distributed.init_process_group)."
        )
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(
            f"Mesh shape {shape} does not match the world size {n}."
        )
    if len(shape) != len(axis_names):
        raise ValueError(
            f"Mesh shape {shape} and axis names {tuple(axis_names)} differ "
            "in length."
        )
    device_type = device_lib.resolve(device_type).type
    return Mesh(init_device_mesh(device_type, shape,
                                 mesh_dim_names=tuple(axis_names)),
                axis_names)


def local_data_parallel_mesh() -> Mesh:
    """All ranks on the data axis (the common one-host layout)."""
    return create_mesh()


def replicated(x: Tensor, mesh: Optional[Mesh], axis: str) -> Tensor:
    """`x` as the rank at coordinate 0 of `axis` holds it, on every rank
    of that axis (a replicated placement)."""
    return broadcast(x, mesh, axis, src=0)
