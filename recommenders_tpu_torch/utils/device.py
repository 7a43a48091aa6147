"""Device resolution and host→device copies for the port's entry points.

Entry points default to `"cuda"` and run on the CPU only when asked to.
A CUDA request on a machine without CUDA raises instead of silently
running on the CPU.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
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


def to_device(batch: Any, device: torch.device,
              stream: Optional[torch.cuda.Stream] = None):
    """`(batch on device, ready event)`: each tensor (or NumPy array) of
    a dict batch (or a lone tensor) copied to `device`; other values pass
    through.

    With a CUDA `stream`, host tensors are copied from pinned memory with
    `non_blocking=True` on that stream, and the returned event marks the
    copies done: the consumer waits on it (`wait_batch`), and the copies
    overlap the work already queued on its own stream (the counterpart
    of JAX's async `device_put`). Without one, the copies are ordinary
    and the event is None."""

    def move(value):
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        if not isinstance(value, torch.Tensor) or value.device == device:
            return value
        if stream is None:
            return value.to(device)
        if value.device.type == "cpu" and not value.is_pinned():
            value = value.pin_memory()
        return value.to(device, non_blocking=True)

    def move_all():
        if isinstance(batch, Mapping):
            return {k: move(v) for k, v in batch.items()}
        return move(batch)

    if stream is None:
        return move_all(), None
    with torch.cuda.stream(stream):
        moved = move_all()
        ready = torch.cuda.Event()
        ready.record(stream)
    return moved, ready


def wait_batch(batch: Any, ready: Optional[torch.cuda.Event]) -> Any:
    """Makes the current stream wait for `to_device`'s copies, and marks
    the copied tensors as used on it (they were allocated on the copy
    stream)."""
    if ready is None:
        return batch
    current = torch.cuda.current_stream()
    current.wait_event(ready)
    values = batch.values() if isinstance(batch, Mapping) else [batch]
    for value in values:
        if isinstance(value, torch.Tensor) and value.is_cuda:
            value.record_stream(current)
    return batch
