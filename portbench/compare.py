"""The comparison that decides `correct`: what the timed path answered
against what the reference (`reference/`) says it should have.

Three numbers, each the worst over the sampled requests, each relative
to the reference's best score of the query (so a number is a share of
the score scale, whatever the catalog's norms):

- `score_gap`: how far a returned score lies from the reference's score
  of the returned row;
- `rank_gap`: how far the reference's score of a returned row lies below
  the reference's k-th best: a row that should not have been returned;
- `code_gap`: how far a stored row, decoded, lies from the reference's
  quantization of the same catalog row (sampled stored rows), relative
  to the row's largest decoded value.

A result that is not `[Q, k]` rows of the catalog, distinct in each
query, with finite non-increasing scores, is malformed: its request
counts in `failed`, whatever the numbers say.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

NUMBERS = ("score_gap", "rank_gap", "code_gap", "recall_loss")


def malformed(scores: Tensor, ids: Tensor, queries: int, k: int,
              rows: int) -> bool:
    """Whether one request's host result breaks the result's form."""
    if tuple(scores.shape) != (queries, k) or tuple(ids.shape) != (queries,
                                                                  k):
        return True
    if ids.dtype.is_floating_point or not bool(torch.isfinite(scores).all()):
        return True
    if bool(((ids < 0) | (ids >= rows)).any()):
        return True
    if bool((scores[:, 1:] > scores[:, :-1]).any()):
        return True
    sorted_ids = ids.sort(dim=1).values
    return bool((sorted_ids[:, 1:] == sorted_ids[:, :-1]).any())


def result_gaps(got_scores: Tensor, ref_of_got: Tensor,
                ref_top: Tensor) -> dict:
    """`score_gap` and `rank_gap` of `[Q, k]` returned scores, the
    reference's scores of the returned rows and its own top-k scores."""
    norm = ref_top[:, :1].abs().clamp_min(1e-30)
    score = ((got_scores - ref_of_got).abs() / norm)
    got_sorted = ref_of_got.sort(dim=1, descending=True).values
    rank = ((ref_top - got_sorted).clamp_min(0.0) / norm)
    # A returned row outside the catalog scores NaN: the widest gap.
    score = torch.nan_to_num(score, nan=float("inf"))
    rank = torch.nan_to_num(rank, nan=float("inf"))
    return {"score_gap": float(score.max()), "rank_gap": float(rank.max())}


def missed(ids: Tensor, exact_rows: Tensor) -> int:
    """How many of the `[Q, k]` exact top rows `exact_rows` the `[Q, k]`
    returned `ids` do not hold."""
    hit = (exact_rows.long()[:, :, None] == ids.long()[:, None, :]).any(2)
    return int((~hit).sum())


def code_gap(codes: Tensor, scales: Tensor, ref_codes: Tensor,
             ref_scales: Tensor) -> float:
    """Worst relative gap between stored rows decoded (`[m, D]` codes
    times `[m]` scales) and the reference's decoding of the same rows."""
    got = codes.to(torch.float64) * scales.to(torch.float64)[:, None]
    want = (ref_codes.to(torch.float64)
            * ref_scales.to(torch.float64)[:, None])
    norm = want.abs().amax(dim=1).clamp_min(1e-30)
    return float(((got - want).abs().amax(dim=1) / norm).max())


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (a missing number fails)."""
    return all(numbers.get(name) is not None
               and np.isfinite(numbers[name])
               and numbers[name] <= limits[name] for name in limits)
