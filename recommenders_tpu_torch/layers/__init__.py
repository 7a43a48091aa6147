"""Layers: retrieval indexes, tower blocks, feature interactions,
sequence encoders and loss shaping."""

from recommenders_tpu_torch.layers import approximate
from recommenders_tpu_torch.layers import blocks
from recommenders_tpu_torch.layers import factorized_top_k
from recommenders_tpu_torch.layers import feature_interaction
from recommenders_tpu_torch.layers import loss
from recommenders_tpu_torch.layers import sequential
from recommenders_tpu_torch.layers.approximate import ScaNN
from recommenders_tpu_torch.layers.sequential import GRUEncoder
from recommenders_tpu_torch.layers.sequential import SelfAttentionEncoder

__all__ = ["approximate", "blocks", "factorized_top_k", "feature_interaction",
           "loss", "sequential", "GRUEncoder", "ScaNN",
           "SelfAttentionEncoder"]
