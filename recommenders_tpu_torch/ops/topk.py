"""Top-K primitives: merge, corpus padding, streaming scan, exclusion.

Port of `recommenders_tpu/ops/topk.py` onto torch tensors.

Corpora are padded to a row multiple and padding rows are masked to
`MIN_FLOAT` (not `-inf`) so they can never enter a top-k set.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from recommenders_tpu_torch.utils import collectives

Tensor = torch.Tensor

# Same value as the JAX package: finfo(f32).min / 100, a finite floor
# that survives being shifted by the 1e5 exclusion penalty.
MIN_FLOAT = float(np.finfo(np.float32).min / 100.0)

# Score penalty that pushes excluded identifiers below every real score.
EXCLUSION_PENALTY = 1.0e5


def top_k(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Row-wise top-k: `(values, indices)`, sorted descending."""
    return torch.topk(scores, k, dim=-1, largest=True, sorted=True)


def take_along_rows(data: Tensor, indices: Tensor) -> Tensor:
    """`data[i, indices[i, j]]` (the reference's `_take_along_axis`,
    tensorflow_recommenders/layers/factorized_top_k.py:57)."""
    return torch.gather(data, 1, indices.long())


def topk_merge(
    state: Tuple[Tensor, Tensor],
    update: Tuple[Tensor, Tensor],
    k: int,
) -> Tuple[Tensor, Tensor]:
    """Merges two `(scores, ids)` top-k states into one of width `k`.

    Inputs are `[q, m]` and `[q, n]`; the output is `[q, min(k, m + n)]`,
    sorted descending.
    """
    joined_scores = torch.cat([state[0], update[0]], dim=1)
    joined_ids = torch.cat([state[1], update[1]], dim=1)
    k = min(k, joined_scores.shape[1])
    scores, indices = top_k(joined_scores, k)
    return scores, take_along_rows(joined_ids, indices)


def pad_corpus(
    candidates: Tensor,
    identifiers: Optional[Tensor],
    multiple: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Pads a corpus to a row-count multiple; returns (candidates, ids, valid).

    Padding rows are zero embeddings flagged invalid in the `[padded_n]`
    bool mask. Identifiers default to `arange(n)` (int32) and padding ids
    are 0; they are unreachable because scoring masks invalid rows.
    """
    n = candidates.shape[0]
    padded_n = ((n + multiple - 1) // multiple) * multiple
    device = candidates.device
    if identifiers is None:
        identifiers = torch.arange(n, dtype=torch.int32, device=device)
    valid = torch.arange(padded_n, device=device) < n
    if padded_n != n:
        candidates = F.pad(candidates, (0, 0, 0, padded_n - n))
        identifiers = F.pad(identifiers, (0, padded_n - n))
    return candidates, identifiers, valid


def streaming_top_k(
    queries: Tensor,
    candidates: Tensor,
    identifiers: Tensor,
    valid: Tensor,
    k: int,
    chunk_size: int = 4096,
) -> Tuple[Tensor, Tensor]:
    """Exact top-k over a chunked corpus, one chunk at a time.

    The JAX package runs this as one `lax.scan` whose carry is the
    running `[q, k]` state (`recommenders_tpu/ops/topk.py:89-150`); here
    it is a loop over chunks, each a matmul, a mask of the padding rows,
    `torch.topk` and `topk_merge`, so the `[q, n]` score matrix never
    exists at once.

    Args:
      queries: `[q, d]` query embeddings.
      candidates: `[n, d]` corpus, `n` a multiple of `chunk_size` (use
        `pad_corpus`).
      identifiers: `[n]` candidate ids.
      valid: `[n]` bool mask; False rows are padding.
      k: Number of results.
      chunk_size: Candidate rows scored a chunk.

    Returns:
      `([q, k] scores, [q, k] ids)`, sorted descending by score.
    """
    n = candidates.shape[0]
    if n % chunk_size != 0:
        raise ValueError(
            f"corpus rows ({n}) must be a multiple of chunk_size "
            f"({chunk_size}); use pad_corpus first."
        )
    q = queries.shape[0]
    k = min(k, n)
    state = (
        torch.full((q, k), MIN_FLOAT, dtype=torch.float32,
                   device=queries.device),
        torch.zeros((q, k), dtype=identifiers.dtype, device=queries.device),
    )
    for start in range(0, n, chunk_size):
        rows = slice(start, start + chunk_size)
        scores = (queries @ candidates[rows].T).to(torch.float32)
        scores = torch.where(valid[rows][None, :], scores, MIN_FLOAT)
        chunk_scores, idx = top_k(scores, min(k, chunk_size))
        state = topk_merge(state, (chunk_scores, identifiers[rows][idx]), k)
    return state


def exclude(
    scores: Tensor, identifiers: Tensor, exclusions: Tensor, k: int
) -> Tuple[Tensor, Tensor]:
    """Removes excluded identifiers from over-fetched top-k results.

    Rows whose identifier appears in that row of `exclusions` have their
    score lowered by `EXCLUSION_PENALTY`, then the top `k` survivors are
    reselected, returning their *original* scores (reference `_exclude`,
    tensorflow_recommenders/layers/factorized_top_k.py:83-115).

    Args:
      scores: `[q, m]` candidate scores (m >= k).
      identifiers: `[q, m]` candidate ids aligned with scores.
      exclusions: `[q, e]` ids to exclude per row.
      k: Number of results to keep.

    Returns:
      `([q, k] scores, [q, k] ids)`.
    """
    isin = torch.any(identifiers[:, :, None] == exclusions[:, None, :], dim=-1)
    adjusted = scores - isin.to(scores.dtype) * EXCLUSION_PENALTY
    k = min(k, scores.shape[1])
    _, indices = top_k(adjusted, k)
    return take_along_rows(scores, indices), take_along_rows(
        identifiers, indices
    )


def distributed_top_k(
    scores: Tensor,
    identifiers: Tensor,
    k: int,
    mesh: "collectives.Mesh",
    axis: str,
) -> Tuple[Tensor, Tensor]:
    """Global top-k over a corpus sharded across a mesh axis.

    Each rank contributes its local `[q, m]` (scores, ids); every rank
    gets the global `[q, k]` top-k. The reduction is local top-k →
    `all_gather` of the k-wide partials along dim 1, in axis order →
    re-top-k (`recommenders_tpu/ops/topk.py:183-205`). On a one-rank
    axis it is the local top-k alone.
    """
    kk = min(k, scores.shape[1])
    local_scores, idx = top_k(scores, kk)
    local_ids = take_along_rows(identifiers, idx)
    if collectives.axis_size(mesh, axis) == 1:
        return local_scores, local_ids
    all_scores = collectives.all_gather(local_scores, mesh, axis, dim=1)
    all_ids = collectives.all_gather(local_ids, mesh, axis, dim=1)
    k = min(k, all_scores.shape[1])
    top_scores, top_idx = top_k(all_scores, k)
    return top_scores, take_along_rows(all_ids, top_idx)
