"""String → activation resolution (port of `recommenders_tpu.utils.activations`).

Each entry computes what its `jax.nn` namesake computes: `gelu` is the
tanh approximation (`jax.nn.gelu` defaults to `approximate=True`),
`leaky_relu` has slope 0.01 and `softmax` runs over the last axis.
"""

import functools
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

Activation = Union[str, Callable[[torch.Tensor], torch.Tensor], None]

_ACTIVATIONS = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "softmax": functools.partial(F.softmax, dim=-1),
    "softplus": F.softplus,
    "elu": F.elu,
    "leaky_relu": functools.partial(F.leaky_relu, negative_slope=0.01),
    "swish": F.silu,
    "silu": F.silu,
    "linear": lambda x: x,
}


def get(
    activation: Activation,
) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """Resolves an activation spec to a callable (or None for identity)."""
    if activation is None:
        return None
    if callable(activation):
        return activation
    try:
        return _ACTIVATIONS[activation]
    except KeyError:
        raise ValueError(
            f"Unknown activation {activation!r}. "
            f"Known: {sorted(_ACTIVATIONS)}"
        ) from None
