"""Layers: retrieval indexes and tower blocks."""

from recommenders_tpu_torch.layers import blocks
from recommenders_tpu_torch.layers import factorized_top_k

__all__ = ["blocks", "factorized_top_k"]
