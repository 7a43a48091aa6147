"""Distributed corpus scoring: the candidate corpus sharded over a mesh
axis.

Port of `recommenders_tpu/parallel/corpus.py`. Every rank scores the
(replicated) queries against its own rows of the corpus (one matmul),
takes a local top-k, and the global result is an `all_gather` of the
k-wide partials followed by a re-top-k (`ops.topk.distributed_top_k`):
`k · ranks` columns cross the group instead of the corpus.

`ShardedBruteForce` wraps this as a `TopK` index, so corpus-level
evaluation (`metrics.FactorizedTopK`) and serving run unchanged on a
sharded corpus. On a one-rank axis it is plain brute force.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from recommenders_tpu_torch.layers import factorized_top_k as layers_ftk
from recommenders_tpu_torch.ops import scoring
from recommenders_tpu_torch.ops import topk as topk_ops
from recommenders_tpu_torch.parallel import mesh as mesh_lib

Tensor = torch.Tensor

MIN_FLOAT = topk_ops.MIN_FLOAT


def default_mesh(mesh: Optional[mesh_lib.Mesh], axis: str,
                 device: torch.device) -> mesh_lib.Mesh:
    """`mesh`, or every rank on the one axis `axis`."""
    if mesh is not None:
        return mesh
    import torch.distributed as dist

    return mesh_lib.create_mesh(shape=(dist.get_world_size(),),
                                axis_names=(axis,),
                                device_type=device.type)


def shard_rows(x: Tensor, mesh: mesh_lib.Mesh, axis: str) -> Tensor:
    """This rank's contiguous slice of `x`'s rows (`P(axis)`); the rows
    must divide over the axis."""
    s = mesh_lib.axis_size(mesh, axis)
    rows = x.shape[0] // s
    i = mesh_lib.axis_index(mesh, axis)
    return x[i * rows:(i + 1) * rows]


def make_sharded_top_k(
    mesh: mesh_lib.Mesh, axis: str, k: int
) -> Callable[[Tensor, Tensor, Tensor, Tensor], Tuple[Tensor, Tensor]]:
    """`(queries, candidates, identifiers, valid) → ([q, k] scores,
    [q, k] ids)` over a corpus row-sharded along `axis`.

    Queries are replicated; `candidates`, `identifiers` and `valid` are
    this rank's rows. Each rank computes exact local scores and a local
    top-k; across ranks, the k-wide partials are gathered and re-top-k'd.
    """

    def query(queries, candidates, identifiers, valid):
        scores = (queries @ candidates.T).to(torch.float32)
        scores = torch.where(valid[None, :], scores, MIN_FLOAT)
        ids2d = identifiers[None, :].expand(scores.shape[0], -1)
        return topk_ops.distributed_top_k(scores, ids2d, k, mesh, axis)

    return query


class ShardedBruteForce(layers_ftk.TopK):
    """Exact brute-force retrieval over a mesh-sharded corpus.

    Same contract as `BruteForce`, but `index` keeps only this rank's
    rows of the corpus (padded so every rank holds the same lane-aligned
    count) and queries run on every rank, each returning the global
    result. Every rank calls `index` with the same corpus and the same
    queries.

    Attributes:
      query_fn: Optional query-embedding function.
      mesh: Device mesh; defaults to every rank on one `axis`.
      axis: Mesh axis sharding the corpus rows.
      device: Where this rank's shard lives (default CUDA).
    """

    def __init__(
        self,
        query_fn: Optional[Callable] = None,
        k: int = 10,
        mesh: Optional[mesh_lib.Mesh] = None,
        axis: str = mesh_lib.MODEL_AXIS,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__(k=k, device=device)
        self.query_fn = query_fn
        self._mesh = default_mesh(mesh, axis, self.device)
        self._axis = axis
        self._candidates: Optional[Tensor] = None
        self._fns = {}

    def index(
        self,
        candidates: Tensor,
        identifiers: Optional[Tensor] = None,
    ) -> "ShardedBruteForce":
        candidates = layers_ftk._check_candidates(candidates, self.device)
        self._num_candidates = candidates.shape[0]
        identifiers = self._intern_identifiers(
            identifiers, self._num_candidates
        )
        s = mesh_lib.axis_size(self._mesh, self._axis)
        # Pad so every rank holds the same (lane-aligned) row count.
        candidates, identifiers, valid = topk_ops.pad_corpus(
            candidates, identifiers, s * 128
        )
        self._candidates = shard_rows(candidates, self._mesh,
                                      self._axis).contiguous()
        self._identifiers = shard_rows(identifiers, self._mesh, self._axis)
        self._valid = shard_rows(valid, self._mesh, self._axis)
        self._fns = {}
        return self

    def __call__(
        self, queries, k: Optional[int] = None
    ) -> Tuple[Tensor, Tensor]:
        k = k if k is not None else self._k
        if self._candidates is None:
            raise ValueError(
                "The `index` method must be called first to "
                "create the retrieval index."
            )
        if self.query_fn is not None:
            queries = self.query_fn(queries)
        k = min(k, self._num_candidates)
        if k not in self._fns:
            self._fns[k] = make_sharded_top_k(self._mesh, self._axis, k)
        with scoring._full_f32_matmul():
            return self._decode(*self._fns[k](
                queries, self._candidates, self._identifiers, self._valid
            ))

    def is_exact(self) -> bool:
        return True
