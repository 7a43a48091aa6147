"""Utilities: device resolution, activations, weight conversion."""

from recommenders_tpu_torch.utils import activations
from recommenders_tpu_torch.utils import convert
from recommenders_tpu_torch.utils import device

__all__ = ["activations", "convert", "device"]
