"""Model base, trainer and prebuilt models."""

from recommenders_tpu_torch.models import base
from recommenders_tpu_torch.models import retrieval
from recommenders_tpu_torch.models.base import Model
from recommenders_tpu_torch.models.base import Trainer
from recommenders_tpu_torch.models.base import TrainState
from recommenders_tpu_torch.models.retrieval import EmbeddingTower
from recommenders_tpu_torch.models.retrieval import SequenceTower
from recommenders_tpu_torch.models.retrieval import TwoTowerRetrieval
from recommenders_tpu_torch.models.retrieval import (
    evaluate_with_corpus_metrics,
)
from recommenders_tpu_torch.models.retrieval import make_corpus_eval_step

__all__ = [
    "EmbeddingTower",
    "Model",
    "SequenceTower",
    "TrainState",
    "Trainer",
    "TwoTowerRetrieval",
    "base",
    "evaluate_with_corpus_metrics",
    "make_corpus_eval_step",
    "retrieval",
]
