"""Per-row int8/int4 corpus quantization with optional anisotropic scales.

Port of `recommenders_tpu/ops/quantization.py:38-207`. The math is the
same, line for line: abs-max scales, or the anisotropic closed form with
η = (d−1)·T²/(1−T²) (Guo et al. 2020, the ScaNN paper) alternated with
`round(v / s)` for a few iterations. Rounding is half-to-even
(`torch.round`, like `jnp.round` and `np.round`).

Int4 codes pack two per byte along the ROW axis: byte `(c, d)` holds row
`c` in its low nibble and row `c + n/2` in its high nibble
(`pack_nibbles`). The bucketed scoring kernel reads this layout directly.

`quantize_rows` is the NumPy twin, kept as a copy so the port never
imports the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_QMAX = {8: 127.0, 4: 7.0}


def _eta(threshold: float, d: int) -> float:
    t = float(threshold)
    return max((d - 1) * t * t / max(1.0 - t * t, 1e-6), 1.0)


def quantize_block(
    embs: Tensor,
    anisotropic_threshold: Optional[float],
    iterations: int = 3,
    bits: int = 8,
) -> Tuple[Tensor, Tensor]:
    """Quantizes `[..., D]` rows to (f32 scales, int8-stored codes).

    `bits=8` clips codes to ±127; `bits=4` to ±7 (pack pairs of 4-bit
    codes per byte with `pack_nibbles` for storage and scanning).
    """
    qmax = _QMAX[bits]
    v = embs.to(torch.float32)
    scales = torch.clamp(v.abs().amax(dim=-1), min=1e-12) / qmax
    if anisotropic_threshold is None:
        codes = torch.clamp(torch.round(v / scales[..., None]), -qmax, qmax)
        return scales, codes.to(torch.int8)

    eta = _eta(anisotropic_threshold, v.shape[-1])
    norm2 = torch.sum(torch.square(v), dim=-1)
    s = scales
    codes = None
    for _ in range(iterations):
        codes = torch.clamp(torch.round(v / s[..., None]), -qmax, qmax)
        a = torch.sum(v * codes, dim=-1)
        b = torch.sum(torch.square(codes), dim=-1)
        denom = (eta - 1.0) * torch.square(a) / torch.clamp(
            norm2, min=1e-12
        ) + b
        s = torch.where(
            (b > 0) & (norm2 > 0),
            eta * a / torch.clamp(denom, min=1e-12),
            s,
        )
        s = torch.clamp(s, min=1e-12)
    return s.to(torch.float32), codes.to(torch.int8)


def quantize_rows_device(
    embs: Tensor,
    anisotropic_threshold: Optional[float],
    iterations: int = 3,
    chunk: int = 1 << 20,
    bits: int = 8,
) -> Tuple[Tensor, Tensor]:
    """Row quantization on the tensor's device, in blocks of `chunk` rows.

    Rows quantize independently, so the f32 intermediates exist only at
    `[chunk, D]`; outputs are written block by block into preallocated
    tensors.
    """
    n, d = embs.shape
    if n <= chunk:
        return quantize_block(embs, anisotropic_threshold, iterations, bits)
    scales = torch.empty((n,), dtype=torch.float32, device=embs.device)
    codes = torch.empty((n, d), dtype=torch.int8, device=embs.device)
    for start in range(0, n, chunk):
        bs, bc = quantize_block(
            embs[start:start + chunk], anisotropic_threshold, iterations,
            bits,
        )
        scales[start:start + chunk] = bs
        codes[start:start + chunk] = bc
    return scales, codes


def pack_nibbles(codes: Tensor) -> Tensor:
    """Packs 4-bit codes two per byte along the row axis.

    `codes`: `[..., n, d]` int8 with values in [-8, 7], `n` even. Byte
    `(c, d)` of the `[..., n/2, d]` result holds row `c`'s code in its low
    nibble and row `c + n/2`'s in its high nibble, so each decoded half is
    a contiguous row range. `(lo & 15) | (hi << 4)` stays in [-128, 127]
    in int32, so the int8 cast is exact.
    """
    n = codes.shape[-2]
    if n % 2:
        raise ValueError(f"pack_nibbles needs an even row count, got {n}")
    half = n // 2
    lo = codes[..., :half, :].to(torch.int32)
    hi = codes[..., half:, :].to(torch.int32)
    return ((lo & 15) | (hi << 4)).to(torch.int8)


def merge_nibbles(current: Tensor, codes: Tensor, high: bool) -> Tensor:
    """`current` packed bytes with 4-bit `codes` ORed into their high or
    low nibble (`pack_nibbles` layout), as int8. The target nibble of
    `current` must be zero: each (byte, nibble) is written once."""
    cur = current.to(torch.int32)
    new = codes.to(torch.int32)
    merged = (cur & 255) | (new << 4) if high else cur | (new & 15)
    return merged.to(torch.int8)


def unpack_nibbles(packed: Tensor) -> Tensor:
    """Inverse of `pack_nibbles`: `[..., n/2, d]` int8 → `[..., n, d]`.

    The low nibble sign-extends as `((p & 15) ^ 8) - 8` (equal to the
    kernel's `(p << 28) >> 28`), the high one by an arithmetic `>> 4`.
    """
    p = packed.to(torch.int32)
    lo = (((p & 15) ^ 8) - 8).to(torch.int8)
    hi = (p >> 4).to(torch.int8)
    return torch.cat([lo, hi], dim=-2)


def quantize_rows(
    embs: np.ndarray,
    anisotropic_threshold: Optional[float],
    iterations: int = 3,
    bits: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy twin of `quantize_rows_device` (host build paths).

    Plain mode (threshold None): abs-max scaling.

    Anisotropic mode: with code q, a = v·q, b = ‖q‖², c² = ‖v‖²,

        L(s) = (η−1)·(‖v‖ − s·a/‖v‖)² + ‖v‖² − 2sa + s²b
        s*   = η·a / ((η−1)·a²/c² + b)

    (η = 1 recovers the least-squares scale a/b). Alternating the code
    `q = round(v/s)` with s* converges in 2-3 iterations.
    """
    qmax = _QMAX[bits]
    v = embs.astype(np.float32)
    scales = np.maximum(np.abs(v).max(axis=-1), 1e-12) / qmax
    if anisotropic_threshold is None:
        codes = np.clip(
            np.round(v / scales[..., None]), -qmax, qmax
        ).astype(np.int8)
        return scales, codes

    eta = _eta(anisotropic_threshold, v.shape[-1])
    norm2 = np.sum(np.square(v), axis=-1)
    s = scales
    codes = None
    for _ in range(iterations):
        codes = np.clip(np.round(v / s[..., None]), -qmax, qmax)
        a = np.sum(v * codes, axis=-1)
        b = np.sum(np.square(codes), axis=-1)
        denom = (eta - 1.0) * np.square(a) / np.maximum(
            norm2, 1e-12
        ) + b
        s = np.where(
            (b > 0) & (norm2 > 0), eta * a / np.maximum(denom, 1e-12), s
        )
        s = np.maximum(s, 1e-12)
    return s.astype(np.float32), codes.astype(np.int8)
