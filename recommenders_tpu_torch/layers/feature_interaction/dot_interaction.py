"""DLRM dot-product feature interaction.

Port of `recommenders_tpu/layers/feature_interaction/dot_interaction.py`
(the counterpart of `tfrs.layers.feature_interaction.DotInteraction`):
all pairwise dot products of the feature embeddings as one batched
`[B, F, D] × [B, D, F]` product, accumulated in f32 and cast back to the
inputs' dtype. The lower triangle is gathered in NumPy's row-major
`tril_indices` order; `skip_gather=True` keeps the full `F×F` matrix
with the rest zeroed.
"""

from typing import Sequence

import torch
from torch import nn

Tensor = torch.Tensor


class DotInteraction(nn.Module):
    """All pairwise dot products between feature embeddings.

    Args:
      self_interaction: Include the diagonal `dot(e_i, e_i)` terms.
      skip_gather: Emit the full `F·F` matrix with the upper triangle
        (and, without `self_interaction`, the diagonal) zeroed, instead
        of gathering the kept triangle.
    """

    def __init__(self, self_interaction: bool = False,
                 skip_gather: bool = False) -> None:
        super().__init__()
        self.self_interaction = self_interaction
        self.skip_gather = skip_gather

    def forward(self, inputs: Sequence[Tensor]) -> Tensor:
        num_features = len(inputs)
        if any(x.shape != inputs[0].shape for x in inputs):
            raise ValueError(
                "Input tensors' dimensions must be equal, got shapes "
                f"{[tuple(x.shape) for x in inputs]}."
            )
        batch_size = inputs[0].shape[0]
        features = torch.stack(inputs, dim=1).to(torch.float32)   # [B, F, D]
        xactions = torch.bmm(features, features.transpose(1, 2)).to(
            inputs[0].dtype)                                       # [B, F, F]
        offset = 0 if self.self_interaction else -1
        rows, cols = torch.tril_indices(num_features, num_features, offset,
                                        device=xactions.device)
        flat_idx = rows * num_features + cols
        flat = xactions.reshape(batch_size, num_features * num_features)
        if self.skip_gather:
            keep = torch.zeros(num_features * num_features, dtype=torch.bool,
                               device=flat.device)
            keep[flat_idx] = True
            return torch.where(keep[None, :], flat, 0.0)
        return flat[:, flat_idx]
