"""Partial embedding: shard big tables, replicate small ones.

Port of `recommenders_tpu/embedding/partial.py` (the counterpart of the
reference's `PartialTPUEmbedding`): tables with `vocabulary_size >
size_threshold` go to the `sharded_embedding` collection, the rest to
`dense_embedding`. The routing is kept for its parameter layout
(`embedding.sharded_embedding.<table>` and
`embedding.dense_embedding.<table>`, the flax paths); on one device
both partitions hold whole tables.
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
                big, shard_tables=True, device=device,
                generator=generator, mesh=mesh, table_axis=table_axis)
        if small:
            self.dense_embedding = embedding_lib.TpuEmbedding(
                small, shard_tables=False, device=device,
                generator=generator)

    def forward(
        self, features: Mapping[str, embedding_lib.FeatureInput]
    ) -> Dict[str, Tensor]:
        unknown = set(features) - set(self._partition)
        if unknown:
            raise ValueError(
                f"Features {sorted(unknown)} have no FeatureConfig.")
        out: Dict[str, Tensor] = {}
        for part in ("sharded_embedding", "dense_embedding"):
            inputs = {k: v for k, v in features.items()
                      if self._partition[k] == part}
            if inputs:
                out.update(getattr(self, part)(inputs))
        return out
