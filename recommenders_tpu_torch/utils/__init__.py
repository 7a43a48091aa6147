"""Utilities: device resolution, activations, weight conversion,
profiling."""

from recommenders_tpu_torch.utils import activations
from recommenders_tpu_torch.utils import convert
from recommenders_tpu_torch.utils import device
from recommenders_tpu_torch.utils import profiling

__all__ = ["activations", "convert", "device", "profiling"]
