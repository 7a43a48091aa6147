"""Convenience blocks for building towers.

Port of `recommenders_tpu/layers/blocks.py:17-53` (itself the counterpart
of `tfrs.layers.blocks.MLP`) as an `nn.Module` of `nn.Linear` layers.
Flax infers each layer's input width at first call; here it is given.
"""

from typing import Optional, Sequence, Union

import torch
from torch import nn

from recommenders_tpu_torch.utils import activations as activations_lib
from recommenders_tpu_torch.utils import device as device_lib


class MLP(nn.Module):
    """Sequential multi-layer perceptron block.

    Args:
      in_features: Input width.
      units: Layer sizes; the last entry is the output width.
      use_bias: Whether layers include bias terms.
      activation: Activation for all but the last layer (string or callable).
      final_activation: Activation for the last layer.
      device: Where the weights live (default CUDA).
    """

    def __init__(
        self,
        in_features: int,
        units: Sequence[int],
        use_bias: bool = True,
        activation: activations_lib.Activation = "relu",
        final_activation: activations_lib.Activation = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__()
        device = device_lib.resolve(device)
        widths = [in_features, *units]
        self.layers = nn.ModuleList(
            nn.Linear(a, b, bias=use_bias, device=device)
            for a, b in zip(widths[:-1], widths[1:])
        )
        self.activation = activations_lib.get(activation)
        self.final_activation = activations_lib.get(final_activation)

    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        """Flax's `Dense` initialisation: lecun-normal kernels, zero bias."""
        for layer in self.layers:
            lecun_normal_(layer.weight, generator)
            if layer.bias is not None:
                nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.logits(x)
        if self.final_activation is not None:
            x = self.final_activation(x)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The output before the last layer's activation."""
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last and self.activation is not None:
                x = self.activation(x)
        return x


# Standard deviation of a unit normal truncated to [-2, 2]; flax's
# truncated-normal initialisers divide by it so the kept draws have the
# requested standard deviation.
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def truncated_normal_(
    tensor: torch.Tensor, stddev: float,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Flax's `truncated_normal(stddev)`: draws cut at ±2σ, rescaled so
    their standard deviation is `stddev`."""
    scale = stddev / _TRUNCATED_STD
    return nn.init.trunc_normal_(
        tensor, std=scale, a=-2 * scale, b=2 * scale, generator=generator
    )


def lecun_normal_(
    weight: torch.Tensor, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Flax's default `Dense` kernel init, for an `nn.Linear` weight."""
    return truncated_normal_(weight, weight.shape[1] ** -0.5, generator)
