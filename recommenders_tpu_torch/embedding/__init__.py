"""Embedding tables: configuration, lookups, sparse optimizers, engine."""

from recommenders_tpu_torch.embedding import config
from recommenders_tpu_torch.embedding import embedding
from recommenders_tpu_torch.embedding import engine
from recommenders_tpu_torch.embedding import sparse_optimizer
from recommenders_tpu_torch.embedding.config import FeatureConfig
from recommenders_tpu_torch.embedding.config import OptimizerSpec
from recommenders_tpu_torch.embedding.config import PAD_ID
from recommenders_tpu_torch.embedding.config import TableConfig
from recommenders_tpu_torch.embedding.engine import EmbeddingEngine
from recommenders_tpu_torch.embedding.engine import EngineState

__all__ = [
    "EmbeddingEngine", "EngineState", "FeatureConfig", "OptimizerSpec",
    "PAD_ID", "TableConfig", "config", "embedding", "engine",
    "sparse_optimizer",
]
