"""Feature interaction layers: DCN-v2 cross, stacked DCN, DLRM dots."""

from recommenders_tpu_torch.layers.feature_interaction.dcn import Cross
from recommenders_tpu_torch.layers.feature_interaction.dcn import (
    MultiLayerDCN,
)
from recommenders_tpu_torch.layers.feature_interaction.dot_interaction import (
    DotInteraction,
)

__all__ = ["Cross", "MultiLayerDCN", "DotInteraction"]
