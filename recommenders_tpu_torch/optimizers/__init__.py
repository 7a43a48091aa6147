"""Optimizers: Clippy Adagrad and composite (partitioned) optimization."""

from recommenders_tpu_torch.optimizers.clippy_adagrad import ClippyAdagrad
from recommenders_tpu_torch.optimizers.clippy_adagrad import (
    shrink_by_references,
)
from recommenders_tpu_torch.optimizers.composite import composite_optimizer
from recommenders_tpu_torch.optimizers.composite import path_contains

__all__ = [
    "ClippyAdagrad",
    "composite_optimizer",
    "path_contains",
    "shrink_by_references",
]
