"""What an index should answer, in plain PyTorch, from the reference's
own quantized catalog (`quantize.quantize_catalog`).

Scores are the configuration's numerics: the query rounded to bf16, where
the codes are exact; f32 sums with TF32 off; the row's scale after the
dot. Selection is by the index's stated semantics, or exact (`exact_top_k`,
the truth recall is counted against):

- Bucketed: row r folds into bucket r % B, the first maximum in row
  order winning; the top k of the B winners.
- ScaNN: queries score the centroids; with a probe tile T > 1 they sort
  by nearest centroid, and each tile of T probes the union of its
  members' top ⌊P/T⌋ leaves (topped up from the tile's best by its
  members' maximum); slot c of a probed leaf folds into bucket c % B,
  leaves in ascending order, then groups of B slots, the first maximum
  winning; the top k of the B winners.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# The floor of an empty cell: finfo(f32).min / 100, as the port's.
MIN_FLOAT = float(torch.finfo(torch.float32).min) / 100.0


@contextlib.contextmanager
def full_f32():
    """CUDA f32 matmuls in f32, not TF32, inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def scores(queries: Tensor, codes: Tensor, scales: Tensor) -> Tensor:
    """`[Q, n]` f32 scores of `[n, D]` int8 codes with `[n]` scales."""
    q = queries.to(torch.bfloat16).to(torch.float32)
    with full_f32():
        out = q @ codes.to(torch.float32).T
    return out * scales[None, :]


def scores_of(queries: Tensor, rows: Tensor, codes: Tensor,
              scales: Tensor) -> Tensor:
    """`[Q, k]` scores of the catalog rows `rows [Q, k]` for their own
    query; a row outside the catalog scores NaN."""
    n = codes.shape[0]
    inside = (rows >= 0) & (rows < n)
    safe = torch.where(inside, rows, 0).long()
    q = queries.to(torch.bfloat16).to(torch.float64)
    dots = torch.einsum("qd,qkd->qk", q, codes[safe].to(torch.float64))
    out = (dots.to(torch.float32) * scales[safe])
    return out.masked_fill(~inside, float("nan"))


def _fold(best_v: Tensor, best_r: Tensor, vals: Tensor, rows: Tensor,
          buckets: int) -> Tuple[Tensor, Tensor]:
    """Folds `[Q, m·B]` scores (and their `[Q or 1, m·B]` rows) in
    order into the running `[Q, B]` first-maximum state."""
    q = vals.shape[0]
    v, g = vals.view(q, -1, buckets).max(dim=1)
    r = torch.gather(rows.view(rows.shape[0], -1, buckets).expand(
        q, -1, -1), 1, g[:, None]).squeeze(1)
    better = v > best_v
    return torch.where(better, v, best_v), torch.where(better, r, best_r)


def _pad_to(x: Tensor, multiple: int, value) -> Tensor:
    pad = (-x.shape[-1]) % multiple
    return F.pad(x, (0, pad), value=value) if pad else x


def bucketed_top_k(queries: Tensor, codes: Tensor, scales: Tensor,
                   buckets: int, k: int, block_rows: int = 1 << 20
                   ) -> Tuple[Tensor, Tensor]:
    """([Q, k] scores, [Q, k] int64 rows) of a Bucketed index over the
    whole catalog, in blocks of `block_rows` rows (a multiple of B)."""
    if block_rows % buckets:
        raise ValueError(f"blocks of {block_rows} rows split buckets of "
                         f"{buckets}")
    q, n = queries.shape[0], codes.shape[0]
    device = queries.device
    best_v = torch.full((q, buckets), MIN_FLOAT, device=device)
    best_r = torch.full((q, buckets), -1, dtype=torch.long, device=device)
    for r0 in range(0, n, block_rows):
        r1 = min(r0 + block_rows, n)
        vals = _pad_to(scores(queries, codes[r0:r1], scales[r0:r1]),
                       buckets, MIN_FLOAT)
        rows = _pad_to(torch.arange(r0, r1, device=device)[None], buckets,
                       -1)
        best_v, best_r = _fold(best_v, best_r, vals, rows, buckets)
    top_v, idx = torch.topk(best_v, min(k, buckets), dim=1)
    return top_v, torch.gather(best_r, 1, idx)


def exact_top_k(queries: Tensor, codes: Tensor, scales: Tensor, k: int,
                block_rows: int = 1 << 20) -> Tuple[Tensor, Tensor]:
    """([Q, k] scores, [Q, k] int64 rows) of the k best rows of the whole
    catalog, in blocks of `block_rows` rows."""
    n = codes.shape[0]
    best_v = best_r = None
    for r0 in range(0, n, block_rows):
        r1 = min(r0 + block_rows, n)
        v, r = torch.topk(scores(queries, codes[r0:r1], scales[r0:r1]),
                          min(k, r1 - r0), dim=1)
        r = r + r0
        if best_v is not None:
            v, r = torch.cat([best_v, v], 1), torch.cat([best_r, r], 1)
        best_v, idx = torch.topk(v, min(k, v.shape[1]), dim=1)
        best_r = torch.gather(r, 1, idx)
    return best_v, best_r


def tile_probes(cscores: Tensor, num_probes: int, tile: int
                ) -> Tuple[Tensor, list]:
    """(query order, each tile's probed leaves, ascending and distinct)
    from `[Q, L]` centroid scores, by the tiling the module docstring
    states."""
    q = cscores.shape[0]
    if tile == 1:
        idx = torch.topk(cscores, num_probes, dim=1).indices
        return (torch.arange(q, device=cscores.device),
                [torch.unique(idx[i]) for i in range(q)])
    order = torch.argsort(torch.argmax(cscores, dim=1), stable=True)
    ordered = cscores[order].view(q // tile, tile, -1)
    p_each = num_probes // tile
    rem = num_probes - p_each * tile
    tiles = []
    for t in range(ordered.shape[0]):
        parts = []
        if p_each:
            parts.append(torch.topk(ordered[t], p_each, dim=1)
                         .indices.reshape(-1))
        if rem:
            parts.append(torch.topk(ordered[t].amax(dim=0), rem).indices)
        tiles.append(torch.unique(torch.cat(parts)))
    return order, tiles


def scann_top_k(queries: Tensor, centroids: Tensor, leaf_rows: Tensor,
                codes: Tensor, scales: Tensor, num_probes: int, tile: int,
                buckets: int, k: int, leaf_block: int = 64
                ) -> Tuple[Tensor, Tensor]:
    """([Q, k] scores, [Q, k] int64 rows) of a ScaNN index with bucketed
    scoring over the partition `centroids [L, D]`, `leaf_rows [L, cap]`
    (-1 for an empty slot); `Q` is a multiple of `tile`."""
    q = queries.shape[0]
    cap = leaf_rows.shape[1]
    buckets = min(buckets, cap)
    with full_f32():
        cscores = queries.to(torch.float32) @ centroids.T
    order, tiles = tile_probes(cscores, num_probes, tile)
    ordered = queries[order]
    t = 1 if tile == 1 else tile
    out_v = torch.empty((q, buckets), device=queries.device)
    out_r = torch.empty((q, buckets), dtype=torch.long,
                        device=queries.device)
    for i, leaves in enumerate(tiles):
        qt = ordered[i * t:(i + 1) * t]
        best_v = torch.full((t, buckets), MIN_FLOAT, device=queries.device)
        best_r = torch.full((t, buckets), -1, dtype=torch.long,
                            device=queries.device)
        for b0 in range(0, leaves.numel(), leaf_block):
            rows = leaf_rows[leaves[b0:b0 + leaf_block]].long()  # [nb, cap]
            valid = rows >= 0
            safe = torch.where(valid, rows, 0).reshape(-1)
            vals = scores(qt, codes[safe], scales[safe]).view(
                t, -1, cap).masked_fill(~valid[None], MIN_FLOAT)
            vals = _pad_to(vals, buckets, MIN_FLOAT).reshape(t, -1)
            rows = _pad_to(torch.where(valid, rows, -1), buckets,
                           -1).reshape(1, -1)
            best_v, best_r = _fold(best_v, best_r, vals, rows, buckets)
        out_v[order[i * t:(i + 1) * t]] = best_v
        out_r[order[i * t:(i + 1) * t]] = best_r
    top_v, idx = torch.topk(out_v, min(k, buckets), dim=1)
    return top_v, torch.gather(out_r, 1, idx)
