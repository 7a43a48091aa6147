"""Streaming metrics: corpus-level factorized top-K plus standard scalars."""

from recommenders_tpu_torch.metrics.base import AUC
from recommenders_tpu_torch.metrics.base import BinaryAccuracy
from recommenders_tpu_torch.metrics.base import CategoricalAccuracy
from recommenders_tpu_torch.metrics.base import Mean
from recommenders_tpu_torch.metrics.base import MeanAbsoluteError
from recommenders_tpu_torch.metrics.base import NDCG
from recommenders_tpu_torch.metrics.base import Metric
from recommenders_tpu_torch.metrics.base import RootMeanSquaredError
from recommenders_tpu_torch.metrics.base import Sum
from recommenders_tpu_torch.metrics.base import TopKCategoricalAccuracy
from recommenders_tpu_torch.metrics.base import init_all
from recommenders_tpu_torch.metrics.base import merge_states
from recommenders_tpu_torch.metrics.base import result_all
from recommenders_tpu_torch.metrics.factorized_top_k import Factorized
from recommenders_tpu_torch.metrics.factorized_top_k import FactorizedTopK

__all__ = [
    "AUC",
    "BinaryAccuracy",
    "CategoricalAccuracy",
    "Mean",
    "MeanAbsoluteError",
    "NDCG",
    "Metric",
    "RootMeanSquaredError",
    "Sum",
    "TopKCategoricalAccuracy",
    "init_all",
    "merge_states",
    "result_all",
    "Factorized",
    "FactorizedTopK",
]
