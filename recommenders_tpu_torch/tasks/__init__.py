"""Tasks: losses of recommender models (retrieval and ranking)."""

from recommenders_tpu_torch.tasks import base
from recommenders_tpu_torch.tasks import listwise
from recommenders_tpu_torch.tasks import ranking
from recommenders_tpu_torch.tasks import retrieval
from recommenders_tpu_torch.tasks.base import Task
from recommenders_tpu_torch.tasks.ranking import Ranking
from recommenders_tpu_torch.tasks.ranking import RankingOutput
from recommenders_tpu_torch.tasks.ranking import binary_crossentropy
from recommenders_tpu_torch.tasks.ranking import mean_squared_error
from recommenders_tpu_torch.tasks.retrieval import Retrieval
from recommenders_tpu_torch.tasks.retrieval import RetrievalOutput
from recommenders_tpu_torch.tasks.retrieval import softmax_cross_entropy

__all__ = [
    "Ranking", "RankingOutput", "Retrieval", "RetrievalOutput", "Task",
    "base", "binary_crossentropy", "listwise", "mean_squared_error",
    "ranking", "retrieval", "softmax_cross_entropy",
]
