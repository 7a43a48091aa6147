"""Utilities: device resolution, activations, checkpointing, weight
conversion, profiling, mesh axes and collectives."""

from recommenders_tpu_torch.utils import activations
from recommenders_tpu_torch.utils import checkpoint
from recommenders_tpu_torch.utils import collectives
from recommenders_tpu_torch.utils import convert
from recommenders_tpu_torch.utils import device
from recommenders_tpu_torch.utils import profiling

__all__ = ["activations", "checkpoint", "collectives", "convert", "device",
           "profiling"]
