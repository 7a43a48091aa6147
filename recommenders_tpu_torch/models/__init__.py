"""Model base, trainers and prebuilt models."""

from recommenders_tpu_torch.models import base
from recommenders_tpu_torch.models import hybrid
from recommenders_tpu_torch.models import multitask
from recommenders_tpu_torch.models import ranking
from recommenders_tpu_torch.models import retrieval
from recommenders_tpu_torch.models.base import Model
from recommenders_tpu_torch.models.base import Trainer
from recommenders_tpu_torch.models.base import TrainState
from recommenders_tpu_torch.models.hybrid import HybridState
from recommenders_tpu_torch.models.hybrid import HybridTrainer
from recommenders_tpu_torch.models.multitask import Multitask
from recommenders_tpu_torch.models.ranking import Ranking
from recommenders_tpu_torch.models.retrieval import EmbeddingTower
from recommenders_tpu_torch.models.retrieval import SequenceTower
from recommenders_tpu_torch.models.retrieval import TwoTowerRetrieval
from recommenders_tpu_torch.models.retrieval import (
    evaluate_with_corpus_metrics,
)
from recommenders_tpu_torch.models.retrieval import make_corpus_eval_step

__all__ = [
    "EmbeddingTower",
    "HybridState",
    "HybridTrainer",
    "Model",
    "Multitask",
    "Ranking",
    "SequenceTower",
    "TrainState",
    "Trainer",
    "TwoTowerRetrieval",
    "base",
    "evaluate_with_corpus_metrics",
    "hybrid",
    "make_corpus_eval_step",
    "multitask",
    "ranking",
    "retrieval",
]
