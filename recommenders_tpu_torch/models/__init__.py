"""Prebuilt models."""

from recommenders_tpu_torch.models import retrieval
from recommenders_tpu_torch.models.retrieval import EmbeddingTower
from recommenders_tpu_torch.models.retrieval import TwoTowerRetrieval

__all__ = ["EmbeddingTower", "TwoTowerRetrieval", "retrieval"]
