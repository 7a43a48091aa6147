"""Per-row int8 / int4 quantization with anisotropic scales.

A frozen copy of the port's `ops/quantization.py:quantize_block` (itself
the JAX package's): abs-max scales, then `iterations` rounds of the
anisotropic closed form (Guo et al. 2020, arXiv:1908.10396) with
η = (d−1)·T²/(1−T²), alternated with `round(v / s)` (half to even).
Codes stay unpacked in int8 for both widths: the reference reads them
as numbers, not as a storage layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

QMAX = {8: 127.0, 4: 7.0}


def _eta(threshold: float, d: int) -> float:
    t = float(threshold)
    return max((d - 1) * t * t / max(1.0 - t * t, 1e-6), 1.0)


def quantize(rows: Tensor, threshold: Optional[float], bits: int,
             iterations: int = 3) -> Tuple[Tensor, Tensor]:
    """`[n, D]` rows → (`[n]` f32 scales, `[n, D]` int8 codes within
    ±QMAX[bits])."""
    qmax = QMAX[bits]
    v = rows.to(torch.float32)
    scales = torch.clamp(v.abs().amax(dim=-1), min=1e-12) / qmax
    if threshold is None:
        codes = torch.clamp(torch.round(v / scales[:, None]), -qmax, qmax)
        return scales, codes.to(torch.int8)
    eta = _eta(threshold, v.shape[-1])
    norm2 = torch.sum(torch.square(v), dim=-1)
    s = scales
    codes = None
    for _ in range(iterations):
        codes = torch.clamp(torch.round(v / s[:, None]), -qmax, qmax)
        a = torch.sum(v * codes, dim=-1)
        b = torch.sum(torch.square(codes), dim=-1)
        denom = (eta - 1.0) * torch.square(a) / torch.clamp(
            norm2, min=1e-12) + b
        s = torch.where((b > 0) & (norm2 > 0),
                        eta * a / torch.clamp(denom, min=1e-12), s)
        s = torch.clamp(s, min=1e-12)
    return s.to(torch.float32), codes.to(torch.int8)


def quantize_catalog(batches, rows: int, dim: int, threshold, bits: int,
                     device: torch.device, block: int = 1 << 20):
    """The whole catalog quantized in row order: (`[rows, dim]` int8
    codes, `[rows]` f32 scales), from an iterator of `[b, dim]` blocks,
    each quantized in blocks of at most `block` rows."""
    codes = torch.empty((rows, dim), dtype=torch.int8, device=device)
    scales = torch.empty((rows,), dtype=torch.float32, device=device)
    off = 0
    for batch in batches:
        for start in range(0, batch.shape[0], block):
            part = batch[start:start + block]
            s, c = quantize(part, threshold, bits)
            codes[off:off + part.shape[0]] = c
            scales[off:off + part.shape[0]] = s
            off += part.shape[0]
    if off != rows:
        raise ValueError(f"the catalog gave {off} rows, not {rows}")
    return codes, scales
