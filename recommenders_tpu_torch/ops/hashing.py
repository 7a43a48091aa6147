"""Deterministic salted integer hashing for feature bucketing.

Port of `recommenders_tpu/ops/hashing.py:20-49` (`_mix32`, `hash_bucket`):
a murmur3-style 32-bit avalanche mix with two salt injections, bit-equal
to the JAX package on every device.

PyTorch has few `uint32` kernels, so the uint32 values live in int64:
every product is taken `mod 2³²` without overflow (`mul32`), and every
value stays in `[0, 2³²)`, so `>>` is the logical shift. The JAX package
runs with 64-bit types off, so an int64 id is narrowed to int32 before
its uint32 cast: only an id's low 32 bits count, and negative ids wrap.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

Tensor = torch.Tensor

M32 = 0xFFFFFFFF


def mul32(x: Tensor, c: int) -> Tensor:
    """`(x · c) mod 2³²` for `0 ≤ x < 2³²` in int64, without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _mix32(h: Tensor) -> Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def hash_bucket(
    ids: Tensor,
    num_bins: int,
    salt: Union[int, Sequence[int]] = (0, 0),
) -> Tensor:
    """Hashes integer ids into `[0, num_bins)` with the given salt(s).

    Args:
      ids: Integer tensor of any shape, on any device.
      num_bins: Number of hash buckets.
      salt: One or two integers; different salts give independent hashes.

    Returns:
      int32 tensor of bucket ids, same shape and device as `ids`.
    """
    if ids.is_floating_point() or ids.is_complex():
        raise TypeError(f"hash_bucket takes integer ids, got {ids.dtype}")
    if isinstance(salt, int):
        salt = (salt, 0)
    s0, s1 = (int(s) for s in salt)
    h = ids.to(torch.int64) & M32
    h = _mix32(h ^ ((s0 * 0x9E3779B9 + 0x7F4A7C15) & M32))
    h = _mix32(h ^ ((s1 * 0x85EBCA6B + 0x165667B1) & M32))
    return (h % num_bins).to(torch.int32)
