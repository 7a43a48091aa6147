"""Loss-shaping ops for in-batch sampled-softmax retrieval training.

Port of `recommenders_tpu/layers/loss.py:24-127`: hard-negative mining,
accidental-hit removal and the sampling-probability (log-q) correction,
as plain functions of tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor

# Large-but-finite sentinels, so arithmetic on masked logits never makes
# inf or nan (the JAX package's values, float32).
MAX_FLOAT = float(np.finfo(np.float32).max / 100.0)
MIN_FLOAT = float(np.finfo(np.float32).min / 100.0)


def divide_by_temperature(scores: Tensor, temperature: float) -> Tensor:
    """`scores / temperature` as an IEEE division on every device (CUDA
    turns a division by a Python number into a multiply by its
    reciprocal)."""
    return scores / torch.tensor(temperature, dtype=scores.dtype,
                                 device=scores.device)


def take_along_rows(data: Tensor, column_indices: Tensor) -> Tensor:
    """Gathers `data[i, column_indices[i, j]]` for each row i."""
    if data.dim() != 2 or column_indices.dim() != 2:
        raise ValueError(
            "take_along_rows expects 2D inputs, got "
            f"{tuple(data.shape)} and {tuple(column_indices.shape)}."
        )
    return torch.gather(data, 1, column_indices.long())


def hard_negative_mining(
    logits: Tensor, labels: Tensor, num_hard_negatives: int
) -> Tuple[Tensor, Tensor]:
    """Keeps the positive and the `num_hard_negatives` largest negatives.

    The positive is forced into the top-k by adding `MAX_FLOAT` to it;
    `min(num_hard_negatives + 1, num_candidates)` columns are kept.
    """
    num_candidates = logits.shape[1]
    num_sampled = min(num_hard_negatives + 1, num_candidates)
    _, col_indices = torch.topk(logits + labels * MAX_FLOAT, k=num_sampled,
                                dim=1)
    return (
        take_along_rows(logits, col_indices),
        take_along_rows(labels, col_indices),
    )


def remove_accidental_hits(
    labels: Tensor, logits: Tensor, candidate_ids: Tensor
) -> Tensor:
    """Pushes logits of in-batch negatives that share the positive's id
    to MIN_FLOAT: `logits + (duplicate − labels) · MIN_FLOAT`."""
    positive_indices = torch.argmax(labels, dim=1)
    positive_candidate_ids = candidate_ids[positive_indices]
    duplicate = (
        positive_candidate_ids[:, None] == candidate_ids[None, :]
    ).to(labels.dtype)
    duplicate = duplicate - labels
    return logits + duplicate * MIN_FLOAT


def sampling_probability_correction(
    logits: Tensor, candidate_sampling_probability: Tensor
) -> Tensor:
    """Log-q correction: `logits − log(clip(p, 1e-6, 1))`."""
    return logits - torch.log(
        torch.clamp(candidate_sampling_probability, 1e-6, 1.0)
    )
