"""Embedding lookups: the parts the engine uses.

Port of `recommenders_tpu/embedding/embedding.py:44-118`: `_pad_vocab`,
`combine` and `lookup_feature`. Feature semantics:

  - scalar ids `[B]` → `[B, dim]`;
  - multivalent ids `[B, L]` with `PAD_ID` padding → `[B, dim]` through
    the table's combiner (sum / mean / sqrtn), optionally weighted;
  - sequence features (`max_sequence_length > 0`) → `[B, L, dim]` with
    padding positions zeroed.

Negative ids gather row 0; only `PAD_ID` positions are zeroed, as in the
JAX package. The autodiff `TpuEmbedding` module is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from recommenders_tpu_torch.embedding import config as config_lib

Tensor = torch.Tensor
FeatureInput = Union[Tensor, Tuple[Tensor, Tensor]]  # ids or (ids, weights)

PAD_ID = config_lib.PAD_ID

# Tables are padded to a row multiple (the JAX package's mesh divisor).
_ROW_MULTIPLE = 128


def _pad_vocab(vocabulary_size: int) -> int:
    return (
        (vocabulary_size + _ROW_MULTIPLE - 1) // _ROW_MULTIPLE
    ) * _ROW_MULTIPLE


def combine(
    embeddings: Tensor,
    ids: Tensor,
    combiner: str,
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Reduces `[B, L, dim]` lookups to `[B, dim]` with padding masked.

    sum = Σwᵢeᵢ, mean = Σwᵢeᵢ/Σwᵢ, sqrtn = Σwᵢeᵢ/√(Σwᵢ²).
    """
    valid = (ids != PAD_ID).to(embeddings.dtype)
    if weights is None:
        weights = valid
    else:
        weights = weights.to(embeddings.dtype) * valid
    weighted = embeddings * weights[..., None]
    # Summed in sequence order, from zero (XLA's CPU reduction order).
    total = torch.zeros_like(weighted[:, 0])
    for pos in range(weighted.shape[1]):
        total = total + weighted[:, pos]
    if combiner == "sum":
        return total
    if combiner == "mean":
        denom = torch.clamp(torch.sum(weights, dim=1), min=1e-12)
        return total / denom[:, None]
    if combiner == "sqrtn":
        denom = torch.clamp(
            torch.sqrt(torch.sum(torch.square(weights), dim=1)), min=1e-12
        )
        return total / denom[:, None]
    raise ValueError(f"Unknown combiner {combiner!r}")


def gather_rows(table: Tensor, ids: Tensor) -> Tensor:
    """`table[max(ids, 0)]` as a new tensor (never a view), with
    `PAD_ID` positions zeroed."""
    out = torch.index_select(table, 0, torch.clamp(ids.reshape(-1), min=0))
    out = out.view(tuple(ids.shape) + (table.shape[1],))
    return out.masked_fill_((ids == PAD_ID)[..., None], 0.0)


def lookup_feature(
    table: Tensor,
    feature_config: config_lib.FeatureConfig,
    feature: FeatureInput,
) -> Tensor:
    """Looks one feature up in a table. Returns a new tensor."""
    if isinstance(feature, tuple):
        ids, weights = feature
    else:
        ids, weights = feature, None
    if ids.dim() == 1:
        return gather_rows(table, ids)
    if ids.dim() != 2:
        raise ValueError(
            f"Feature {feature_config.name!r} ids must be rank 1 or 2, got "
            f"shape {tuple(ids.shape)}."
        )
    gathered = gather_rows(table, ids)                  # [B, L, dim]
    if feature_config.max_sequence_length > 0:
        return gathered
    return combine(gathered, ids, feature_config.table.combiner, weights)
