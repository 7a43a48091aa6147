"""Layers: retrieval indexes, tower blocks and loss shaping."""

from recommenders_tpu_torch.layers import approximate
from recommenders_tpu_torch.layers import blocks
from recommenders_tpu_torch.layers import factorized_top_k
from recommenders_tpu_torch.layers import loss
from recommenders_tpu_torch.layers.approximate import ScaNN

__all__ = ["approximate", "blocks", "factorized_top_k", "loss", "ScaNN"]
