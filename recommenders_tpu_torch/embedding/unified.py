"""Unified Embedding: feature multiplexing into shared hashed tables.

Port of `recommenders_tpu/embedding/unified.py:26-125` (itself the
counterpart of the reference's `UnifiedEmbedding`,
`tensorflow_recommenders/layers/feature_multiplexing/unified_embedding.py:
68,138`): N categorical features are multi-salt-hashed into a pool of
shared tables assigned round-robin; each feature's `num_chunks` lookups
are concatenated into its final embedding.

The shared tables are a `TpuEmbedding` named `shared_tables`, so its
parameters are `shared_tables.<TableConfig.name>` and
`utils.convert.load_flax_params` carries the JAX module's tables across.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
from torch import nn

from recommenders_tpu_torch.embedding import config as config_lib
from recommenders_tpu_torch.embedding import embedding as embedding_lib
from recommenders_tpu_torch.ops import hashing
from recommenders_tpu_torch.utils import device as device_lib

Tensor = torch.Tensor


class UnifiedEmbeddingConfig:
    """Builds the shared-table + hashing configuration.

    `num_tables` shared tables of `buckets_per_table` x `dim_per_table`
    (named `f"{name}_{i}"`); `add_feature(name, num_chunks)` assigns the
    feature's chunks to tables round-robin and records a distinct
    `(feature_idx, chunk_idx)` hash salt per chunk.
    """

    def __init__(
        self,
        buckets_per_table: int,
        dim_per_table: int,
        num_tables: int,
        name: str,
        **table_kwargs,
    ) -> None:
        self.buckets_per_table = buckets_per_table
        self.name = name
        self._current_table = 0
        self._num_features = 0
        self.table_configs = [
            config_lib.TableConfig(
                vocabulary_size=buckets_per_table,
                dim=dim_per_table,
                name=f"{name}_{i}",
                **table_kwargs,
            )
            for i in range(num_tables)
        ]
        # feature name -> {chunk lookup name: FeatureConfig}
        self.embedding_config: Dict[str, Dict[str, config_lib.FeatureConfig]]
        self.embedding_config = {}
        # feature name -> {chunk lookup name: (num_bins, salt)}
        self.hashing_config: Dict[str, Dict[str, tuple]] = {}

    def add_feature(self, name: str, num_chunks: int, **kwargs) -> None:
        """Registers a feature with `num_chunks` hashed lookups."""
        chunk_embed, chunk_hash = {}, {}
        for chunk_id in range(num_chunks):
            chunk_name = f"{self.name}_{name}_lookup_{chunk_id}"
            chunk_embed[chunk_name] = config_lib.FeatureConfig(
                table=self.table_configs[self._current_table],
                name=chunk_name,
                **kwargs,
            )
            chunk_hash[chunk_name] = (
                self.buckets_per_table,
                (self._num_features, chunk_id),
            )
            self._current_table = (
                self._current_table + 1
            ) % len(self.table_configs)
        self._num_features += 1
        self.embedding_config[name] = chunk_embed
        self.hashing_config[name] = chunk_hash


class UnifiedEmbedding(nn.Module):
    """Hash → shared-table lookup → per-feature concat.

    Returns a list of `[B, num_chunks * dim_per_table]` embeddings in the
    order features were added to the config. A feature's chunks are
    concatenated in the lexicographic order of their lookup names, as in
    the JAX module (`sorted(chunks)`, so `lookup_10` comes before
    `lookup_2`).

    Args:
      config: The shared-table and hashing configuration.
      shard_tables: Row-shard the shared tables over the mesh's table
        axis (with a `mesh`; `TpuEmbedding`).
      device: Where the tables live (default CUDA).
      generator: Optional `torch.Generator` for the initial tables.
      mesh: Optional `parallel.Mesh`.
    """

    def __init__(
        self,
        config: UnifiedEmbeddingConfig,
        shard_tables: bool = True,
        device: device_lib.DeviceLike = "cuda",
        generator: Optional[torch.Generator] = None,
        mesh=None,
    ) -> None:
        super().__init__()
        self.config = config
        self.shard_tables = shard_tables
        self.shared_tables = embedding_lib.TpuEmbedding(
            feature_configs=tuple(
                fc
                for chunks in config.embedding_config.values()
                for fc in chunks.values()
            ),
            shard_tables=shard_tables,
            device=device,
            generator=generator,
            mesh=mesh,
        )

    def forward(self, features: Mapping[str, Tensor]) -> List[Tensor]:
        hashed: Dict[str, Tensor] = {}
        for name, chunks in self.config.hashing_config.items():
            feature = features[name]
            for chunk_name, (num_bins, salt) in chunks.items():
                hashed[chunk_name] = hashing.hash_bucket(
                    feature, num_bins, salt
                )
        activations = self.shared_tables(hashed)
        return [
            torch.cat([activations[k] for k in sorted(chunks)], dim=-1)
            for chunks in self.config.embedding_config.values()
        ]
