"""Embedding tables: configuration, lookups, sparse optimizers, engine,
unified (hashed, shared) embeddings."""

from recommenders_tpu_torch.embedding import config
from recommenders_tpu_torch.embedding import embedding
from recommenders_tpu_torch.embedding import engine
from recommenders_tpu_torch.embedding import partial
from recommenders_tpu_torch.embedding import sparse_optimizer
from recommenders_tpu_torch.embedding import unified
from recommenders_tpu_torch.embedding.config import FeatureConfig
from recommenders_tpu_torch.embedding.config import OptimizerSpec
from recommenders_tpu_torch.embedding.config import PAD_ID
from recommenders_tpu_torch.embedding.config import TableConfig
from recommenders_tpu_torch.embedding.embedding import TpuEmbedding
from recommenders_tpu_torch.embedding.embedding import combine
from recommenders_tpu_torch.embedding.embedding import lookup_feature
from recommenders_tpu_torch.embedding.engine import EmbeddingEngine
from recommenders_tpu_torch.embedding.engine import EngineState
from recommenders_tpu_torch.embedding.partial import PartialEmbedding
from recommenders_tpu_torch.embedding.unified import UnifiedEmbedding
from recommenders_tpu_torch.embedding.unified import UnifiedEmbeddingConfig

__all__ = [
    "EmbeddingEngine", "EngineState", "FeatureConfig", "OptimizerSpec",
    "PAD_ID", "PartialEmbedding", "TableConfig", "TpuEmbedding",
    "UnifiedEmbedding", "UnifiedEmbeddingConfig", "combine", "config",
    "embedding", "engine", "lookup_feature", "partial", "sparse_optimizer",
    "unified",
]
