"""DCN-v2 cross layers.

Port of `recommenders_tpu/layers/feature_interaction/dcn.py` (the
counterparts of `tfrs.layers.feature_interaction.Cross` and
`MultiLayerDCN`): `x_{i+1} = x0 ⊙ (W·x + b + diag_scale·x) + x`, with an
optional low-rank `W = U·V` and preactivation. Flax infers the input
width at the first call; here it is given. Kernels start as flax's
`truncated_normal(0.05)` (a unit normal cut at ±2, times 0.05), biases
at zero.
"""

from typing import Optional, Union

import torch
from torch import nn

from recommenders_tpu_torch.utils import activations as activations_lib
from recommenders_tpu_torch.utils import device as device_lib

Tensor = torch.Tensor

_KERNEL_STD = 0.05


@torch.no_grad()
def _reset(layers, generator: Optional[torch.Generator]) -> None:
    for layer in layers:
        nn.init.trunc_normal_(layer.weight, std=_KERNEL_STD,
                              a=-2 * _KERNEL_STD, b=2 * _KERNEL_STD,
                              generator=generator)
        if layer.bias is not None:
            nn.init.zeros_(layer.bias)


class Cross(nn.Module):
    """Cross layer of a Deep & Cross Network (DCN-v2).

    Args:
      in_features: Width of `x0` and `x`.
      projection_dim: If set, `W = U·V` with inner width `projection_dim`
        (`dense_u`: `[d, p]`, `dense_v`: `[p, d]`); full rank (`dense`)
        otherwise.
      diag_scale: Non-negative float added to W's diagonal.
      use_bias: Whether the (V-side) dense layer has a bias.
      preactivation: Activation of `W·x + b` before the product with `x0`.
      device: Where the weights live (default CUDA).
      generator: Optional `torch.Generator` for the initial weights.
    """

    def __init__(
        self,
        in_features: int,
        projection_dim: Optional[int] = None,
        diag_scale: float = 0.0,
        use_bias: bool = True,
        preactivation: activations_lib.Activation = None,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if diag_scale < 0:
            raise ValueError(f"diag_scale must be >= 0; got {diag_scale}.")
        device = device_lib.resolve(device)
        self.diag_scale = diag_scale
        self.preactivation = activations_lib.get(preactivation)
        if projection_dim is None:
            self.dense = nn.Linear(in_features, in_features, bias=use_bias,
                                   device=device)
            layers = [self.dense]
        else:
            self.dense_u = nn.Linear(in_features, projection_dim, bias=False,
                                     device=device)
            self.dense_v = nn.Linear(projection_dim, in_features,
                                     bias=use_bias, device=device)
            layers = [self.dense_u, self.dense_v]
        self.projection_dim = projection_dim
        _reset(layers, generator)

    def forward(self, x0: Tensor, x: Optional[Tensor] = None) -> Tensor:
        if x is None:
            x = x0
        if x0.shape[-1] != x.shape[-1]:
            raise ValueError(
                "x0 and x must share their last dimension; got "
                f"{x0.shape[-1]} vs {x.shape[-1]}."
            )
        if self.projection_dim is None:
            prod_output = self.dense(x)
        else:
            prod_output = self.dense_v(self.dense_u(x))
        if self.preactivation is not None:
            prod_output = self.preactivation(prod_output)
        if self.diag_scale:
            prod_output = prod_output + self.diag_scale * x
        return x0 * prod_output + x


class MultiLayerDCN(nn.Module):
    """`num_layers` low-rank cross layers over a shared input `x0`.

    Args:
      in_features: Width of `x0`.
      projection_dim: Low-rank inner width of every layer.
      num_layers: Number of stacked cross layers.
      use_bias: Whether the V-side dense layers carry biases.
      device: Where the weights live (default CUDA).
      generator: Optional `torch.Generator` for the initial weights.
    """

    def __init__(
        self,
        in_features: int,
        projection_dim: int = 1,
        num_layers: int = 3,
        use_bias: bool = True,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = device_lib.resolve(device)
        self.dense_u = nn.ModuleList(
            nn.Linear(in_features, projection_dim, bias=False, device=device)
            for _ in range(num_layers))
        self.dense_v = nn.ModuleList(
            nn.Linear(projection_dim, in_features, bias=use_bias,
                      device=device)
            for _ in range(num_layers))
        # Layer by layer, u then v: the order flax creates them in.
        _reset([layer for pair in zip(self.dense_u, self.dense_v)
                for layer in pair], generator)

    def forward(self, x0: Tensor) -> Tensor:
        xl = x0
        for dense_u, dense_v in zip(self.dense_u, self.dense_v):
            xl = x0 * dense_v(dense_u(xl)) + xl
        return xl
