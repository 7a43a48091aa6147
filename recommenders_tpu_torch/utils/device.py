"""Device resolution for the port's entry points.

Entry points default to `"cuda"` and run on the CPU only when asked to.
A CUDA request on a machine without CUDA raises instead of silently
running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve(device: DeviceLike = "cuda") -> torch.device:
    """Returns `torch.device(device)`; raises if it is CUDA and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} was requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU."
        )
    return device
