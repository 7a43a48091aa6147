"""Tasks: losses of recommender models."""

from recommenders_tpu_torch.tasks import base
from recommenders_tpu_torch.tasks import retrieval
from recommenders_tpu_torch.tasks.retrieval import Retrieval
from recommenders_tpu_torch.tasks.retrieval import RetrievalOutput

__all__ = ["Retrieval", "RetrievalOutput", "base", "retrieval"]
