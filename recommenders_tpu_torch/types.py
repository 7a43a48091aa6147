"""Common type aliases (port of `recommenders_tpu/types.py`)."""

from typing import Any, Callable, Dict, Mapping, Union

import torch

Tensor = torch.Tensor
PyTree = Any
Features = Mapping[str, Tensor]
MutableFeatures = Dict[str, Tensor]
Activation = Union[str, Callable[[Tensor], Tensor], None]
