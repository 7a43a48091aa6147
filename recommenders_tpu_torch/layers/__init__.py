"""Layers: retrieval indexes, tower blocks and loss shaping."""

from recommenders_tpu_torch.layers import blocks
from recommenders_tpu_torch.layers import factorized_top_k
from recommenders_tpu_torch.layers import loss

__all__ = ["blocks", "factorized_top_k", "loss"]
