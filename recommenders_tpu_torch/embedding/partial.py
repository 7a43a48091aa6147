"""Partial embedding: shard big tables, replicate small ones.

Port of `recommenders_tpu/embedding/partial.py` (the counterpart of the
reference's `PartialTPUEmbedding`): tables with `vocabulary_size >
size_threshold` go to the `sharded_embedding` collection, the rest to
`dense_embedding`. The routing is kept for its parameter layout
(`embedding.sharded_embedding.<table>` and
`embedding.dense_embedding.<table>`, the flax paths); on one device
both partitions hold whole tables. The poolable features of a call
(`embedding.poolable`), of both partitions, are pooled by one
`ops.pooled_lookup` call; `pooled` writes them straight into the
first columns of a wider row.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from recommenders_tpu_torch.embedding import config as config_lib
from recommenders_tpu_torch.embedding import embedding as embedding_lib
from recommenders_tpu_torch.utils import device as device_lib

Tensor = torch.Tensor


class PartialEmbedding(nn.Module):
    """Routes features to sharded or replicated tables by vocabulary size.

    Args:
      feature_configs: All feature declarations.
      size_threshold: Tables with `vocabulary_size > size_threshold` are
        sharded; the rest replicated. `0` shards everything; `None`
        replicates everything.
      device: Where the tables live (default CUDA).
      dtype: The tables' dtype (both partitions).
      generator: Optional `torch.Generator` for the initial tables
        (sharded partition first).
      mesh: Optional `parallel.Mesh`; the sharded partition's tables are
        row-sharded over its `table_axis`.
      table_axis: The mesh axis sharding the big tables.
    """

    def __init__(
        self,
        feature_configs: Sequence[config_lib.FeatureConfig],
        size_threshold: Optional[int] = 10_000,
        device: device_lib.DeviceLike = "cuda",
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        mesh=None,
        table_axis: str = "model",
    ) -> None:
        super().__init__()
        self.size_threshold = size_threshold
        big, small = [], []
        for fc in feature_configs:
            if (size_threshold is not None
                    and fc.table.vocabulary_size > size_threshold):
                big.append(fc)
            else:
                small.append(fc)
        self._partition = {fc.name: "sharded_embedding" for fc in big}
        self._partition.update({fc.name: "dense_embedding" for fc in small})
        if big:
            self.sharded_embedding = embedding_lib.TpuEmbedding(
                big, shard_tables=True, dtype=dtype, device=device,
                generator=generator, mesh=mesh, table_axis=table_axis)
        if small:
            self.dense_embedding = embedding_lib.TpuEmbedding(
                small, shard_tables=False, dtype=dtype, device=device,
                generator=generator)
        # Each feature's (partition's tables, table name, `pool_formats`),
        # worked out once; a call reads its table by name.
        self._routes = {}
        for part in (getattr(self, "sharded_embedding", None),
                     getattr(self, "dense_embedding", None)):
            for fc in () if part is None else part.feature_configs:
                self._routes[fc.name] = (part._parameters, fc.table.name,
                                         part._pool_formats[fc.name])

    def forward(
        self, features: Mapping[str, embedding_lib.FeatureInput]
    ) -> Dict[str, Tensor]:
        """Each feature's lookup; the poolable ones of both partitions
        pooled by one `pooled_lookup` call."""
        pool, rest = self._entries(features)
        out: Dict[str, Tensor] = {}
        for part in ("sharded_embedding", "dense_embedding"):
            inputs = {k: v for k, v in rest.items()
                      if self._partition[k] == part}
            if inputs:
                out.update(getattr(self, part)(inputs))
        if pool:
            out.update(embedding_lib.split_pooled(
                embedding_lib.pool_features(pool), pool))
        return {k: out[k] for k in features}

    def pooled(self, features: Mapping[str, embedding_lib.FeatureInput],
               out: Optional[Tensor] = None) -> Optional[Tensor]:
        """Every feature pooled by one `pooled_lookup` call, side by side
        in the mapping's order (into the first columns of `out` where
        given), or None where some feature is not poolable."""
        pool, rest = self._entries(features)
        if rest or not pool:
            return None
        return embedding_lib.pool_features(pool, out)

    def _entries(self, features):
        """({feature: (table, input)} of the poolable features
        (`embedding.poolable`), {feature: input} of the rest)."""
        pool, rest = {}, {}
        for name, feature in features.items():
            route = self._routes.get(name)
            if route is None:
                unknown = sorted(set(features) - set(self._routes))
                raise ValueError(
                    f"Features {unknown} have no FeatureConfig.")
            tables, table_name, formats = route
            table = tables[table_name]
            if embedding_lib.poolable(table, formats, feature):
                pool[name] = (table, feature)
            else:
                rest[name] = feature
        return pool, rest
